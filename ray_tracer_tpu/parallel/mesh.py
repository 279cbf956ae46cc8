"""Multi-device rendering: SPMD over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md §2d: compute and graphics
even share one queue, ``vk_engine.cpp:115-117``).  Here the renderer's two
embarrassingly-parallel axes are sharded over the mesh:

* ``data`` — pixel batches (the DP analogue): each device path-traces its
  pixel shard against a replicated scene (scene arrays are MBs; replication
  is free, SURVEY.md §5).
* ``sample`` — samples-per-pixel (the SP analogue): devices trace disjoint
  sample indices for the *same* pixels and reduce with ``pmean``.

No collective is on the hot path except the final sample-axis ``pmean``.
RNG is counter-based on (pixel, sample), so sharding does not change the
sampled paths (quirk Q9 discipline).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..integrator import wavefront
from ..scene.types import Camera, CompiledScene
from ..api import _camera_arrays, scene_camera

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def make_mesh(
    n_data: Optional[int] = None, n_sample: int = 1, devices=None
) -> Mesh:
    """Build a (data, sample) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_sample
    assert n_data * n_sample == len(devices), "mesh must use all devices"
    dev_array = np.asarray(devices).reshape(n_data, n_sample)
    return Mesh(dev_array, (DATA_AXIS, SAMPLE_AXIS))


def _shard_render(scene, rot, pos, fov, aspect, near, frame, cfg, spp_total,
                  n_local):
    """Per-shard body: trace my pixel shard x my sample-index slice.

    My pixel shard is the ``n_local`` ids after ``data index * n_local``;
    ids past the image (padding of the last shard) re-trace pixel 0.

    Runs the production integrator (``trace_wave``: path regeneration,
    plus coherence binning and the multi-phase drain when enabled) per
    shard.  Per-lane results are independent of
    shard composition (counter-based RNG on pixel/sample), so the image
    is invariant to the mesh shape; non-default estimators fall back to
    the static scan like the single-device path (api._tile_mean).
    """
    pixel_ids = jax.lax.axis_index(DATA_AXIS) * n_local + jnp.arange(
        n_local, dtype=jnp.int32
    )
    pixel_ids = jnp.where(pixel_ids < cfg.n_pixels, pixel_ids, 0)
    n_sample = jax.lax.axis_size(SAMPLE_AXIS)
    my_sample = jax.lax.axis_index(SAMPLE_AXIS)
    spp_local = spp_total // n_sample
    sample_base = my_sample * spp_local

    if cfg.path_regen and cfg.estimator == "mis":
        acc = wavefront.trace_wave(
            scene, rot, pos, fov, aspect, near, pixel_ids, frame,
            jnp.asarray(sample_base, jnp.int32), spp_local, cfg,
        )
    else:
        def one(acc, s):
            c = wavefront.render_sample(
                scene, rot, pos, fov, aspect, near, pixel_ids, frame,
                sample_base + s, cfg,
            )
            return acc + c, None

        acc, _ = jax.lax.scan(
            one,
            jnp.zeros((pixel_ids.shape[0], 3), jnp.float32),
            jnp.arange(spp_local, dtype=jnp.int32),
        )
    color = acc / spp_local
    return jax.lax.pmean(color, SAMPLE_AXIS)


@functools.lru_cache(maxsize=16)
def make_sharded_render_fn(mesh: Mesh, cfg: RenderConfig, spp_total: int):
    """Returns jitted fn(scene, rot, pos, fov, aspect, near, frame) -> (N,3),
    N the pixel count padded to a multiple of the data axis, sharded over
    the data axis, with every input replicated.  Cached per (mesh, cfg,
    spp_total), so each frame after the first reuses the compiled program.
    """
    n_local = -(-cfg.n_pixels // mesh.shape[DATA_AXIS])
    fn = jax.shard_map(
        functools.partial(_shard_render, cfg=cfg, spp_total=spp_total,
                          n_local=n_local),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return jax.jit(fn)


def replicate(scene: CompiledScene, mesh: Mesh) -> CompiledScene:
    """The scene on every device of the mesh.  Replicate once and pass the
    result to each :func:`render_frame_sharded` call: a scene that is
    already replicated is not uploaded again."""
    return scene.device_put(NamedSharding(mesh, P()))


def render_frame_sharded(
    scene: CompiledScene,
    cfg: RenderConfig,
    mesh: Mesh,
    camera: Optional[Camera] = None,
    frame: int = 0,
) -> jnp.ndarray:
    """Full-frame multi-device render -> (H,W,3)."""
    cam = camera or scene_camera(scene)
    replicated = NamedSharding(mesh, P())
    # camera arrays and the frame index go to every device of the mesh,
    # not to the default device alone
    rot, pos, fov, aspect, near = jax.device_put(
        _camera_arrays(cam, cfg), replicated
    )
    frame_dev = jax.device_put(jnp.int32(frame), replicated)
    fn = make_sharded_render_fn(mesh, cfg, cfg.samples_per_pixel)
    out = fn(replicate(scene, mesh), rot, pos, fov, aspect, near, frame_dev)
    out = np.asarray(out)[:cfg.n_pixels]
    return jnp.asarray(out.reshape(cfg.height, cfg.width, 3))
