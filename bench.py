#!/usr/bin/env python
"""Benchmark: one path-traced frame of sponza_proxy on one GPU.

    python bench.py

Workload (env overrides in brackets): ``sponza_proxy`` (270,114 triangles,
284,996 leaf references after spatial splits) [RT_BENCH_SCENE:
sponza_proxy[:N] | cornell] at 1920x1080 [RT_BENCH_WIDTH, RT_BENCH_HEIGHT],
2 samples per pixel [RT_BENCH_SPP], 8 bounces, the whole frame as one
wavefront tile [RT_BENCH_TILE_LOG2].  Traversal follows ``Routing.from_env`` (RT_ROUTE).

One frame compiles and warms up; the next is timed.  Rays counted are the
traversals the reference's stats counters track (primary + bounce + NEE
shadow, raytrace.comp:276): ``rays_sem`` counts every ray the reference
would trace, ``rays_traced`` leaves out NEE rays resolved analytically.

stdout gets ONE JSON line; the device (JAX's platform, device kind and
count, and the card's ``nvidia-smi`` name and power limit) and the frame
time go to stderr beside it.  Any failure, including a backend that is not
a GPU, exits non-zero.
"""

import json
import os
import sys
import time

import numpy as np


def scene_builder(name: str):
    """The bench scene's SceneBuilder (``compile()`` builds the BVH)."""
    from ray_tracer_tpu.scene import presets

    if name.startswith("sponza_proxy"):
        # "sponza_proxy:N" scales the target triangle count
        n_target = int(name.split(":")[1]) if ":" in name else 260_000
        builder = presets.sponza_proxy(n_target)
    elif name == "cornell":
        builder = presets.default_scene()
    else:
        builder = presets.mesh_scene(name, material=presets.WHITE)
    return builder


def make_frame_fn(scene, cfg, spp: int):
    """``frame(i) -> (color sums (H*W, 3), n_rays [semantic, traced])``.

    One dispatch per pixel tile of ``cfg.max_rays_per_batch`` pixels, all
    ``spp`` samples in the path-regenerating wavefront
    (``wavefront.trace_wave``); the returned function blocks until the
    frame is done.  ``frame.compile()`` compiles without running.
    """
    import jax
    import jax.numpy as jnp

    from ray_tracer_tpu.api import _camera_arrays, scene_camera
    from ray_tracer_tpu.integrator import wavefront

    rot, pos, fov, aspect, near = _camera_arrays(scene_camera(scene), cfg)
    n_pix = cfg.n_pixels
    tile = min(n_pix, cfg.max_rays_per_batch)
    n_tiles = -(-n_pix // tile)

    @jax.jit
    def tile_fn(scene, frame, t):
        ids = jnp.minimum(
            t * tile + jnp.arange(tile, dtype=jnp.int32), jnp.int32(n_pix - 1)
        )
        return wavefront.trace_wave(
            scene, rot, pos, fov, aspect, near, ids, frame,
            jnp.int32(0), spp, cfg, with_stats=True,
        )

    def frame(i: int):
        colors, rays = [], np.zeros(2)
        for t in range(n_tiles):
            c, nr = tile_fn(scene, jnp.int32(i), jnp.int32(t))
            colors.append(c)
            rays += np.asarray(nr)
        c = np.concatenate([np.asarray(x) for x in colors])[:n_pix]
        return c, rays

    def compile_():
        tile_fn.lower(scene, jnp.int32(0), jnp.int32(0)).compile()

    frame.compile = compile_
    return frame


def bench_config(width: int, height: int, tile_log2: int = 21, routing=None):
    from ray_tracer_tpu import RenderConfig

    return RenderConfig(
        width=width, height=height, bounce_limit=8,
        max_rays_per_batch=1 << tile_log2, routing=routing,
    )


def main() -> int:
    import jax

    from ray_tracer_tpu.ops.traverse import resolve_route
    from ray_tracer_tpu.utils.cache import enable_compile_cache
    from ray_tracer_tpu.utils.device import device_record, gpu_name_power

    dev = device_record()
    print(json.dumps({"device": dev, "nvidia_smi": gpu_name_power()}),
          file=sys.stderr)
    if dev["platform"] != "gpu":
        print(f"bench.py: no GPU backend ({jax.default_backend()}); "
              "nothing measured", file=sys.stderr)
        return 1
    enable_compile_cache()

    width = int(os.environ.get("RT_BENCH_WIDTH", 1920))
    height = int(os.environ.get("RT_BENCH_HEIGHT", 1080))
    spp = int(os.environ.get("RT_BENCH_SPP", 2))
    scene_name = os.environ.get("RT_BENCH_SCENE", "sponza_proxy")
    cfg = bench_config(
        width, height, int(os.environ.get("RT_BENCH_TILE_LOG2", 21))
    )

    scene = scene_builder(scene_name).compile().device_put()
    frame = make_frame_fn(scene, cfg, spp)
    frame(0)  # compile + warm up
    t0 = time.perf_counter()
    colors, rays = frame(1)
    dt = time.perf_counter() - t0

    rays_sem, rays_traced = float(rays[0]), float(rays[1])
    checksum = float(colors.astype(np.float64).sum())
    route = resolve_route(scene, cfg.resolved_routing())
    print(json.dumps({"frame_s": dt, "checksum": checksum, "route": route}),
          file=sys.stderr)
    print(json.dumps({
        "metric": f"Mrays/s {scene_name} @{width}x{height} spp{spp} b8",
        "value": rays_sem / dt / 1e6,
        "unit": "Mrays/s",
        "rays_sem": rays_sem,
        "rays_traced": rays_traced,
        "mrays_traced": rays_traced / dt / 1e6,
        "frame_s": dt,
        "checksum": checksum,
        "route": route,
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
