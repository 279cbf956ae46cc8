#!/usr/bin/env python
"""On-card smoke test: the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # the sharded path on four cards

Run from the root of a checkout.  It refuses to run unless JAX's default
backend is a GPU (there is no CPU fallback), and any phase that fails
makes it exit non-zero before the result line.  Phases, one card:

1. the card's ``nvidia-smi`` name and power limit;
2. set-up of the bench scene (sponza_proxy): scene build, BVH build,
   upload, first compile of the bench frame;
3. traversal check at real width: the walk kernel against the XLA gather
   walk on the bench frame's primary rays, first-bounce diffuse rays and
   NEE shadow rays (with ``tmax``);
4. the Cornell goldens rendered on the card;
5. the bench frame (sponza_proxy 1920x1080, spp 2, bounce 8) through the
   default route: time, Mrays/s, checksum;
6. the same frame through the gather walk, compared with the default
   route by checksum and mean |difference|.

``--four`` runs only the sharded path (``parallel.mesh``, what
``cli render --sharded`` calls) on (4, 1) and (2, 2) ``(data, sample)``
meshes and compares each image with the one-card image.

The last stdout line is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

BENCH_W, BENCH_H, BENCH_SPP = 1920, 1080, 2

# Traversal check tolerances (phase 3): both routes are float32 and
# traversal has no matmul, so differences come only from FMA contraction
# and the order of comparisons on exact ties.
MIN_SAME_HIT = 0.9999
MAX_DST_REL = 1e-5
# Golden check on the card (phase 4): float16 golden quantisation plus FMA
# reassociation can flip a rare path, so a bound on the mean and on the
# share of channels off by more than the CPU tests' atol.
GOLDEN_MEAN = 1e-3
GOLDEN_ATOL = 2e-3
GOLDEN_SHARE = 0.995
# Frame comparisons (phases 6 and --four): checksum and mean |difference|.
FRAME_CHECKSUM_REL = 1e-3
FRAME_MEAN = 1e-3


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)
    log(f"  PASS {msg}")


def _block(tree):
    import jax

    return jax.block_until_ready(tree)


def setup_bench_scene(scene_name="sponza_proxy"):
    """Phase 2 part 1: build, BVH and upload times; returns the scene."""
    import bench

    t0 = time.perf_counter()
    builder = bench.scene_builder(scene_name)
    t1 = time.perf_counter()
    host = builder.compile()
    t2 = time.perf_counter()
    scene = _block(host.device_put())
    t3 = time.perf_counter()
    log(
        f"setup: scene build {t1 - t0:.2f} s, BVH build {t2 - t1:.2f} s, "
        f"upload {t3 - t2:.2f} s; {host.meta['n_tris']} triangles, "
        f"{host.bvh_index.shape[0]} BVH nodes, max leaf "
        f"{host.max_leaf_tris}"
    )
    return scene


def _timed(fn, *args):
    out = _block(fn(*args))  # compile + warm up
    t0 = time.perf_counter()
    out = _block(fn(*args))
    return out, time.perf_counter() - t0


def traversal_check(scene, width=BENCH_W, height=BENCH_H, kernel="kernel"):
    """Phase 3: walk kernel vs gather walk on the bench frame's rays.

    ``kernel="interpret"`` checks the kernel's interpreter instead (CPU).
    """
    import jax
    import jax.numpy as jnp

    from ray_tracer_tpu import RenderConfig
    from ray_tracer_tpu.api import _camera_arrays, scene_camera
    from ray_tracer_tpu.config import Routing
    from ray_tracer_tpu.integrator import wavefront
    from ray_tracer_tpu.ops import traverse
    from ray_tracer_tpu.sampling import bsdf, lights, rng

    walk, kern = Routing(route="walk"), Routing(route=kernel)
    cfg = RenderConfig(width=width, height=height)
    rot, pos, fov, aspect, near = _camera_arrays(scene_camera(scene), cfg)
    ids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    cam = wavefront.raygen(rot, pos, fov, aspect, near, ids, width, height)

    @jax.jit
    def derived_rays(scene, o, d, dst, kind, prim):
        """First-bounce diffuse and NEE shadow rays from primary hits."""
        n = o.shape[0]
        hit = traverse.Hit(dst, kind, prim, jnp.zeros_like(prim),
                           jnp.zeros_like(dst), jnp.zeros_like(dst),
                           jnp.zeros(n, bool))
        out = wavefront._shade_fetch(scene, wavefront.CameraRays(o, d), hit)
        hp, normal = out[0], out[1]
        u = rng.uniforms(0, ids, 0, 0, 0, 5)
        did = kind != traverse.KIND_NONE
        b_dir = bsdf.cosine_hemisphere_dir(normal, u[:, 0], u[:, 1])
        b_org = hp + normal * 1e-5
        s_org = hp + normal * 0.01
        l_dir, _, _, l_dist = lights.sample_rect_light(
            scene, s_org, u[:, 2], u[:, 3], u[:, 4]
        )
        s_act = did & (jnp.sum(normal * l_dir, axis=1) > 0.0)
        return b_org, b_dir, did, s_org, l_dir, s_act, l_dist * (1.0 - 1e-3)

    def closest(route):
        return jax.jit(
            lambda sc, o, d, a: traverse.traverse(
                sc, o, d, a, routing=route, need_uv=False
            )
        )

    def anyhit(route):
        return jax.jit(
            lambda sc, o, d, a, t: traverse.traverse_anyhit(
                sc, o, d, a, tmax=t, routing=route
            )
        )

    def compare_closest(name, hw, hk, active):
        a = np.asarray(active)
        kw, kk = np.asarray(hw.kind)[a], np.asarray(hk.kind)[a]
        pw, pk = np.asarray(hw.prim)[a], np.asarray(hk.prim)[a]
        same = (kw == kk) & ((kw == traverse.KIND_NONE) | (pw == pk))
        both = same & (kw != traverse.KIND_NONE)
        dw, dk = np.asarray(hw.dst)[a][both], np.asarray(hk.dst)[a][both]
        rel = np.abs(dk - dw) / np.maximum(np.abs(dw), 1e-30)
        rel_max = float(rel.max()) if rel.size else 0.0
        check(same.mean() >= MIN_SAME_HIT,
              f"{name}: same kind+prim {same.mean():.6f} of {a.sum()} rays "
              f"(>= {MIN_SAME_HIT})")
        check(rel_max <= MAX_DST_REL,
              f"{name}: max rel |dst diff| {rel_max:.3g} where prims agree "
              f"(<= {MAX_DST_REL:g})")

    act = jnp.ones(cfg.n_pixels, bool)
    hw, t_w = _timed(closest(walk), scene, cam.origin, cam.direction, act)
    hk, t_k = _timed(closest(kern), scene, cam.origin, cam.direction, act)
    n = cfg.n_pixels
    log(f"traversal primary closest-hit, {n} rays: kernel {t_k * 1e3:.1f} ms"
        f" ({n / t_k / 1e6:.1f} Mrays/s), walk {t_w * 1e3:.1f} ms "
        f"({n / t_w / 1e6:.1f} Mrays/s)")
    compare_closest("primary", hw, hk, act)

    b_org, b_dir, b_act, s_org, s_dir, s_act, s_tmax = derived_rays(
        scene, cam.origin, cam.direction, hw.dst, hw.kind, hw.prim
    )
    nb = int(np.asarray(b_act).sum())
    bw, t_w = _timed(closest(walk), scene, b_org, b_dir, b_act)
    bk, t_k = _timed(closest(kern), scene, b_org, b_dir, b_act)
    log(f"traversal bounce closest-hit, {nb} active rays: kernel "
        f"{t_k * 1e3:.1f} ms ({nb / t_k / 1e6:.1f} Mrays/s), walk "
        f"{t_w * 1e3:.1f} ms ({nb / t_w / 1e6:.1f} Mrays/s)")
    compare_closest("bounce", bw, bk, b_act)

    ns = int(np.asarray(s_act).sum())
    ow, t_w = _timed(anyhit(walk), scene, s_org, s_dir, s_act, s_tmax)
    ok_, t_k = _timed(anyhit(kern), scene, s_org, s_dir, s_act, s_tmax)
    log(f"traversal shadow any-hit, {ns} active rays: kernel "
        f"{t_k * 1e3:.1f} ms ({ns / t_k / 1e6:.1f} Mrays/s), walk "
        f"{t_w * 1e3:.1f} ms ({ns / t_w / 1e6:.1f} Mrays/s)")
    a = np.asarray(s_act)
    same = (np.asarray(ow) == np.asarray(ok_))[a].mean()
    occ = np.asarray(ow)[a].mean()
    check(same >= MIN_SAME_HIT,
          f"shadow: same occlusion flag {same:.6f} of {ns} rays "
          f"(>= {MIN_SAME_HIT}; {occ:.3f} occluded)")


def golden_check():
    """Phase 4: the Cornell goldens through the default route."""
    from ray_tracer_tpu import RenderConfig, render
    from ray_tracer_tpu.scene import presets

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = RenderConfig(width=40, height=40, samples_per_pixel=8,
                       bounce_limit=6)
    for name, builder in (("cornell", presets.default_scene),
                          ("cornell_spheres", presets.cornell_spheres)):
        golden = np.load(os.path.join(
            here, "tests", "golden", f"{name}_40x40_8spp.npy"
        )).astype(np.float32)
        img = np.asarray(render(builder().compile().device_put(), cfg))
        d = np.abs(img - golden)
        share = float((d <= GOLDEN_ATOL).mean())
        check(np.isfinite(img).all() and d.mean() <= GOLDEN_MEAN
              and share >= GOLDEN_SHARE,
              f"golden {name}: mean |diff| {d.mean():.3g} (<= {GOLDEN_MEAN:g}"
              f"), {share:.4f} of channels within {GOLDEN_ATOL:g} "
              f"(>= {GOLDEN_SHARE}), max {d.max():.3g}")


def bench_frame(scene, width, height, routing=None, label="default route"):
    """Phases 2/5/6: compile, warm up and time one bench frame.

    Returns (per-pixel color sums, checksum, frame seconds).
    """
    import bench

    cfg = bench.bench_config(width, height, routing=routing)
    frame = bench.make_frame_fn(scene, cfg, BENCH_SPP)
    t0 = time.perf_counter()
    frame.compile()
    t1 = time.perf_counter()
    frame(0)  # warm up
    t2 = time.perf_counter()
    colors, rays = frame(1)
    dt = time.perf_counter() - t2
    checksum = float(colors.astype(np.float64).sum())
    log(
        f"frame {label} {width}x{height} spp{BENCH_SPP} b8: first compile "
        f"{t1 - t0:.1f} s, warm-up frame {t2 - t1:.2f} s, frame {dt:.4f} s, "
        f"{rays[0] / dt / 1e6:.3f} Mrays/s semantic, "
        f"{rays[1] / dt / 1e6:.3f} Mrays/s traced "
        f"({rays[0]:.0f} / {rays[1]:.0f} rays), checksum {checksum:.6f}"
    )
    check(np.isfinite(colors).all() and colors.shape == (width * height, 3)
          and checksum > 0, f"frame {label}: finite, shape ({width * height},"
          " 3), nonzero")
    return colors, checksum, dt


def compare_frames(name, a, b, sum_a, sum_b):
    rel = abs(sum_a - sum_b) / max(abs(sum_b), 1e-30)
    mean = float(np.abs(a - b).mean())
    check(rel <= FRAME_CHECKSUM_REL and mean <= FRAME_MEAN,
          f"{name}: checksum rel diff {rel:.3g} (<= {FRAME_CHECKSUM_REL:g}), "
          f"mean |diff| {mean:.3g} (<= {FRAME_MEAN:g}) per pixel channel "
          "of the color sums")


def sharded_check(scene_host, width=BENCH_W, height=BENCH_H,
                  meshes=((4, 1), (2, 2))):
    """--four: the sharded render on each mesh against the one-card image."""
    import jax

    from ray_tracer_tpu import RenderConfig, render_frame
    from ray_tracer_tpu.parallel import mesh as pmesh

    n_dev = meshes[0][0] * meshes[0][1]
    n_pix = width * height
    # one-card reference: tiles the size of a (n_dev, 1) shard
    cfg = RenderConfig(width=width, height=height,
                       samples_per_pixel=BENCH_SPP, bounce_limit=8,
                       max_rays_per_batch=-(-n_pix // n_dev))
    scene0 = scene_host.device_put()
    single = np.asarray(_block(render_frame(scene0, cfg)))
    t0 = time.perf_counter()
    single = np.asarray(_block(render_frame(scene0, cfg)))
    log(f"sharded: one-card image {width}x{height} spp{BENCH_SPP} b8 on "
        f"{jax.devices()[0]}: {time.perf_counter() - t0:.3f} s")
    for n_data, n_sample in meshes:
        mesh = pmesh.make_mesh(n_data=n_data, n_sample=n_sample,
                               devices=jax.devices()[:n_dev])
        t0 = time.perf_counter()
        scene = _block(pmesh.replicate(scene_host, mesh))
        t1 = time.perf_counter()
        img = np.asarray(pmesh.render_frame_sharded(scene, cfg, mesh))
        t2 = time.perf_counter()
        img = np.asarray(pmesh.render_frame_sharded(scene, cfg, mesh))
        t3 = time.perf_counter()
        log(f"sharded: ({n_data},{n_sample}) mesh: scene upload "
            f"{t1 - t0:.3f} s, first frame (compile) {t2 - t1:.3f} s, "
            f"warm frame {t3 - t2:.4f} s")
        check(np.isfinite(img).all() and img.shape == single.shape,
              f"({n_data},{n_sample}) mesh: finite, shape {img.shape}")
        compare_frames(f"({n_data},{n_sample}) mesh vs one card", img,
                       single, float(img.astype(np.float64).sum()),
                       float(single.astype(np.float64).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    import jax

    from ray_tracer_tpu.config import Routing
    from ray_tracer_tpu.utils.cache import enable_compile_cache
    from ray_tracer_tpu.utils.device import device_record, gpu_name_power

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke.py: JAX backend is {backend!r}, not a GPU; "
              "refusing to run", file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    dev = device_record()
    log(f"nvidia-smi: {gpu_name_power()}")
    log(f"jax {jax.__version__}: {dev}; compile cache {cache}")

    if args.four:
        if dev["count"] < 4:
            raise SmokeFailure(f"--four needs 4 devices, found {dev['count']}")
        t0 = time.perf_counter()
        from ray_tracer_tpu.scene import presets

        host = presets.sponza_proxy().compile()
        log(f"setup: scene + BVH build {time.perf_counter() - t0:.2f} s")
        sharded_check(host)
    else:
        scene = setup_bench_scene()
        traversal_check(scene)
        golden_check()
        colors, checksum, _ = bench_frame(scene, BENCH_W, BENCH_H)
        w_colors, w_checksum, _ = bench_frame(
            scene, BENCH_W, BENCH_H, routing=Routing(route="walk"),
            label="gather walk",
        )
        compare_frames(f"walk vs default route {BENCH_W}x{BENCH_H}",
                       w_colors, colors, w_checksum, checksum)

    log(f"nvidia-smi: {gpu_name_power()}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
