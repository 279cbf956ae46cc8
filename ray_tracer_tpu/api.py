"""Top-level rendering API.

Replaces the reference's engine loop (``VulkanEngine::draw``/``run_compute``,
``src/vk_engine.cpp:1623-1815``) with three entry points:

* :func:`render` — one-shot: trace ``cfg.samples_per_pixel`` samples and
  return the (H, W, 3) linear image (the reference's ``singleRender`` mode,
  quirk Q10).
* :class:`ProgressiveRenderer` — the progressive mode: each :meth:`step`
  traces one frame and blends it with weight ``1/(frame+1)``; camera moves
  reset accumulation exactly like the reference (``vk_engine.cpp:1812,1888``).
  Render state ``(accum, frame, seed)`` is serializable — the
  checkpoint/resume capability the reference lacks (SURVEY §5).
* :func:`make_sample_fn` — the raw jitted kernel for benchmarks/tests.

Images are tiled into ``cfg.max_rays_per_batch``-ray chunks so arbitrarily
large renders bound their live wavefront memory.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from .config import RenderConfig
from .integrator import film, wavefront
from .scene.types import Camera, CompiledScene
from .utils.transforms import camera_rotation


def _camera_arrays(cam: Camera, cfg: RenderConfig):
    rot = jnp.asarray(camera_rotation(cam.angles_deg))
    pos = jnp.asarray(cam.position, jnp.float32)
    fov = jnp.float32(cam.fov)
    aspect = jnp.float32(cfg.width / cfg.height)
    near = jnp.float32(cam.near_plane)
    return rot, pos, fov, aspect, near


def scene_camera(scene: CompiledScene) -> Camera:
    pos, angles, fov, near = scene.meta.get(
        "camera", ((0.0, -0.5, -3.5), (4.0, 0.0, 0.0), 50.0, 0.1)
    )
    return Camera(position=pos, angles_deg=angles, fov=fov, near_plane=near)


def _tile_mean(
    scene: CompiledScene,
    rot,
    pos,
    fov,
    aspect,
    near,
    pixel_ids,
    frame,
    sample_base,
    cfg: RenderConfig,
    n_samples: int,
):
    """Mean of ``n_samples`` traced samples for the given pixels -> (N,3)."""
    if cfg.path_regen and cfg.estimator == "mis":
        acc = wavefront.trace_wave(
            scene, rot, pos, fov, aspect, near, pixel_ids, frame,
            sample_base, n_samples, cfg,
        )
        return acc / n_samples

    def one_sample(acc, s):
        c = wavefront.render_sample(
            scene, rot, pos, fov, aspect, near, pixel_ids, frame,
            sample_base + s, cfg,
        )
        return acc + c, None

    acc, _ = jax.lax.scan(
        one_sample,
        jnp.zeros((pixel_ids.shape[0], 3), jnp.float32),
        jnp.arange(n_samples, dtype=jnp.int32),
    )
    return acc / n_samples


_render_tile = jax.jit(_tile_mean, static_argnames=("cfg", "n_samples"))


def render_frame(
    scene: CompiledScene,
    cfg: RenderConfig,
    camera: Optional[Camera] = None,
    frame: int = 0,
    n_samples: Optional[int] = None,
    sample_base: int = 0,
) -> jnp.ndarray:
    """Trace one frame (``n_samples`` spp, default config's) -> (H,W,3)."""
    cam = camera or scene_camera(scene)
    rot, pos, fov, aspect, near = _camera_arrays(cam, cfg)
    spp = cfg.samples_per_pixel if n_samples is None else n_samples
    n_pix = cfg.n_pixels
    tile = max(1, min(n_pix, cfg.max_rays_per_batch))
    n_tiles = -(-n_pix // tile)
    # One dispatch per (tile, spp-chunk), NOT one whole-frame program: the
    # tile bounds the live wavefront memory and the chunk bounds one
    # program's run time (a hard scene at high spp is minutes of device
    # time).
    chunk = max(1, min(spp, cfg.max_spp_per_dispatch))
    outs = []
    for t in range(n_tiles):
        ids = jnp.minimum(
            t * tile + jnp.arange(min(tile, n_pix), dtype=jnp.int32),
            jnp.int32(n_pix - 1),
        )
        acc = None
        done = 0
        while done < spp:
            c = min(chunk, spp - done)
            part = _render_tile(
                scene, rot, pos, fov, aspect, near, ids,
                jnp.int32(frame), jnp.int32(sample_base + done),
                cfg=cfg, n_samples=c,
            ) * (c / spp)
            acc = part if acc is None else acc + part
            done += c
        outs.append(acc)
    out = outs[0] if n_tiles == 1 else jnp.concatenate(outs)[:n_pix]
    return out.reshape(cfg.height, cfg.width, 3)


def render(
    scene: CompiledScene, cfg: RenderConfig, camera: Optional[Camera] = None
) -> jnp.ndarray:
    """Single render to cfg.samples_per_pixel spp (reference singleRender)."""
    return render_frame(scene, cfg, camera, frame=0)


class ProgressiveRenderer:
    """Progressive accumulation with camera-reset + checkpoint/resume."""

    def __init__(
        self,
        scene: CompiledScene,
        cfg: RenderConfig,
        camera: Optional[Camera] = None,
    ) -> None:
        self.scene = scene
        self.cfg = cfg
        self.camera = camera or scene_camera(scene)
        self.accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
        self.frame = 0
        self.total_samples = 0

    def step(self, n_samples: Optional[int] = None) -> jnp.ndarray:
        spp = n_samples or self.cfg.samples_per_pixel
        color = render_frame(
            self.scene,
            self.cfg,
            self.camera,
            frame=self.frame,
            n_samples=spp,
            sample_base=self.total_samples,
        )
        self.accum = film.progressive_blend(
            self.accum, color, jnp.int32(self.frame)
        )
        self.frame += 1
        self.total_samples += spp
        return self.accum

    def move_camera(self, camera: Camera) -> None:
        """Camera motion resets accumulation (reference vk_engine.cpp:1888)."""
        self.camera = camera
        self.accum = jnp.zeros_like(self.accum)
        self.frame = 0
        self.total_samples = 0

    def set_scene(self, scene: CompiledScene) -> None:
        """Live scene edit (the reference's Update Buffer re-upload,
        vk_engine.cpp:1541-1603): swap the compiled scene and restart
        accumulation."""
        self.scene = scene
        self.accum = jnp.zeros_like(self.accum)
        self.frame = 0
        self.total_samples = 0

    # -- checkpoint / resume (capability the reference lacks) -------------
    def save_state(self, path: str) -> None:
        np.savez(
            path,
            accum=np.asarray(self.accum),
            frame=self.frame,
            total_samples=self.total_samples,
            seed=self.cfg.seed,
        )

    def load_state(self, path: str) -> None:
        z = np.load(path)
        assert int(z["seed"]) == self.cfg.seed, "seed mismatch on resume"
        self.accum = jnp.asarray(z["accum"])
        self.frame = int(z["frame"])
        self.total_samples = int(z["total_samples"])


def render_debug(
    scene: CompiledScene,
    cfg: RenderConfig,
    camera: Optional[Camera] = None,
    mode: int = 2,
    box_cap: float = 200.0,
    tri_cap: float = 50.0,
) -> jnp.ndarray:
    """BVH-cost heatmaps, the reference's debug views (raytrace.comp:583-591).

    mode 0: box tests vs box_cap (red above cap); mode 1: triangle tests vs
    tri_cap; mode 2: r = box/cap, b = tri/cap.  Caps default to the
    reference's ImGui defaults (vk_engine.h:168-169).  Counts accumulate
    over the FULL path — primary, every bounce, NEE shadow rays, and all
    ``cfg.samples_per_pixel`` samples — exactly the reference's stats
    threading (one stats[2] through every traversal of every sample,
    raytrace.comp:276,443,496,572).
    """
    from .integrator import wavefront

    cam = camera or scene_camera(scene)
    rot, pos, fov, aspect, near = _camera_arrays(cam, cfg)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def run(scene, rot, pos, fov, aspect, near, ids, cfg):
        rays = wavefront.raygen(
            rot, pos, fov, aspect, near, ids, cfg.width, cfg.height
        )

        def one_sample(acc, s):
            b, t = acc
            _, (box, tri) = wavefront.trace(
                scene, rays, ids, jnp.int32(0), s, cfg, with_heatmap=True
            )
            return (b + box, t + tri), None

        z = jnp.zeros((ids.shape[0],), jnp.float32)
        (box, tri), _ = jax.lax.scan(
            one_sample, (z, z),
            jnp.arange(cfg.samples_per_pixel, dtype=jnp.int32),
        )
        return box, tri

    ids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    box, tri = run(scene, rot, pos, fov, aspect, near, ids, cfg=cfg)
    box = np.asarray(box).reshape(cfg.height, cfg.width)
    tri = np.asarray(tri).reshape(cfg.height, cfg.width)
    img = np.zeros((cfg.height, cfg.width, 3), np.float32)
    if mode == 0:
        v = box / box_cap
        img[...] = v[..., None]
        img[box > box_cap] = (1.0, 0.0, 0.0)
    elif mode == 1:
        v = tri / tri_cap
        img[...] = v[..., None]
        img[tri > tri_cap] = (1.0, 0.0, 0.0)
    else:
        img[..., 0] = box / box_cap
        img[..., 2] = tri / tri_cap
    return jnp.asarray(np.clip(img, 0.0, 1.0))
