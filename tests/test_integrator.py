"""Integrator-level tests: radiometric semantics, film, RNG, progressive."""

import numpy as np
import pytest
import jax.numpy as jnp

from ray_tracer_tpu import ProgressiveRenderer, RenderConfig, render, render_frame
from ray_tracer_tpu.integrator import film, wavefront
from ray_tracer_tpu.sampling import bsdf, rng
from ray_tracer_tpu.scene import presets
from ray_tracer_tpu.scene.builder import SceneBuilder
from ray_tracer_tpu.scene.types import Camera, Environment, Material


CFG = RenderConfig(width=32, height=32, samples_per_pixel=2, bounce_limit=3)


@pytest.fixture(scope="module")
def cornell():
    return presets.default_scene().compile().device_put()


def test_render_finite_nonzero(cornell):
    img = np.asarray(render(cornell, CFG))
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.01


def test_render_deterministic(cornell):
    a = np.asarray(render(cornell, CFG))
    b = np.asarray(render(cornell, CFG))
    np.testing.assert_array_equal(a, b)


def test_seed_changes_noise(cornell):
    a = np.asarray(render(cornell, CFG))
    b = np.asarray(render(cornell, CFG.replace(seed=7)))
    assert np.abs(a - b).max() > 1e-4


def test_tiling_invariance(cornell):
    """Batch slicing must not change results (counter-based RNG, quirk Q9).

    Tolerance is float-ulp level: different batch shapes compile separately
    and XLA may reassociate FMAs, but the sampled paths must be identical.
    """
    a = np.asarray(render(cornell, CFG))
    b = np.asarray(render(cornell, CFG.replace(max_rays_per_batch=100)))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_env_only_scene_matches_formula():
    b = SceneBuilder()
    b.add_material(Material())
    b.set_environment(Environment(enabled=True))
    scene = b.compile().device_put()
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1, bounce_limit=0)
    img = np.asarray(render_frame(scene, cfg, Camera(position=(0, 0, 0), angles_deg=(0, 0, 0))))
    assert np.isfinite(img).all()
    # top rows look up (-y): sky; sky is brighter blue-ish than ground grey
    assert img[0].mean() > 0.3


def test_emissive_seen_directly(cornell):
    """j==0 emission (raytrace.comp:504): camera ray hitting the light shows
    emissionColor * strength."""
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1, bounce_limit=0)
    # camera inside the box looking straight up at the light
    cam = Camera(position=(0.0, -0.5, 0.0), angles_deg=(-90.0, 0.0, 0.0))
    img = np.asarray(render_frame(cornell, cfg, cam))
    assert img.max() == pytest.approx(2.4, rel=1e-3)


def test_progressive_matches_single(cornell):
    """Progressive mean over frames == one render with same total samples is
    NOT bitwise (different sample indices), but must agree statistically."""
    pr = ProgressiveRenderer(cornell, CFG.replace(samples_per_pixel=1))
    for _ in range(8):
        acc = pr.step()
    single = render_frame(cornell, CFG.replace(samples_per_pixel=8), n_samples=8)
    d = np.abs(np.asarray(acc).mean() - np.asarray(single).mean())
    assert d < 0.05


def test_progressive_checkpoint_roundtrip(cornell, tmp_path):
    cfg = CFG.replace(samples_per_pixel=1)
    pr = ProgressiveRenderer(cornell, cfg)
    pr.step()
    pr.step()
    path = str(tmp_path / "state.npz")
    pr.save_state(path)

    pr2 = ProgressiveRenderer(cornell, cfg)
    pr2.load_state(path)
    a = pr.step()
    b = pr2.step()
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_camera_move_resets(cornell):
    pr = ProgressiveRenderer(cornell, CFG)
    pr.step()
    pr.move_camera(Camera(position=(0, -0.5, -2.0)))
    assert pr.frame == 0
    assert float(jnp.abs(pr.accum).max()) == 0.0


def test_rng_uniform_and_decorrelated():
    u = np.asarray(rng.uniforms(0, jnp.arange(4096), 0, 0, 0, 4))
    assert u.shape == (4096, 4)
    assert 0.45 < u.mean() < 0.55
    assert u.min() >= 0.0 and u.max() < 1.0
    # neighbouring pixels decorrelated
    c = np.corrcoef(u[:-1, 0], u[1:, 0])[0, 1]
    assert abs(c) < 0.05


def test_cosine_hemisphere_distribution(rand):
    n = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (20000, 1))
    r = rand.uniform(size=(20000, 2)).astype(np.float32)
    d = np.asarray(bsdf.cosine_hemisphere_dir(n, jnp.asarray(r[:, 0]), jnp.asarray(r[:, 1])))
    assert (d[:, 2] > 0).all()
    # E[cos theta] = 2/3 for pdf = cos/pi
    assert abs(d[:, 2].mean() - 2.0 / 3.0) < 0.01


def test_film_magenta_canary():
    img = jnp.array([[[np.nan, 0.0, 0.0], [0.2, 0.3, 0.4]]])
    out = np.asarray(film.finalize(img))
    np.testing.assert_allclose(out[0, 0], [1, 0, 1])
    np.testing.assert_allclose(out[0, 1], [0.2, 0.3, 0.4], rtol=1e-6)


def test_progressive_blend_weights():
    acc = jnp.ones((2, 2, 3))
    new = jnp.zeros((2, 2, 3))
    out = film.progressive_blend(acc, new, jnp.int32(3))  # w = 1/4
    np.testing.assert_allclose(np.asarray(out), 0.75)


def test_render_debug_heatmaps(cornell):
    from ray_tracer_tpu.api import render_debug

    cfg = RenderConfig(width=16, height=16)
    for mode in (0, 1, 2):
        img = np.asarray(render_debug(cornell, cfg, mode=mode))
        assert img.shape == (16, 16, 3)
        assert np.isfinite(img).all()
        assert img.max() > 0  # some traversal work happened


def test_heatmap_full_path(cornell):
    """Heatmap counters accumulate across the WHOLE path like the
    reference's stats threading (raytrace.comp:276,443,496,572): more
    bounces and more spp can only add tests, and the radiance computed
    alongside is exactly the production (fused-NEE) result."""
    import jax

    from ray_tracer_tpu.api import _camera_arrays, scene_camera

    cfg = RenderConfig(width=16, height=16, nee_anyhit=False)
    cam = scene_camera(cornell)
    rot, pos, fov, aspect, near = _camera_arrays(cam, cfg)
    ids = jnp.arange(16 * 16, dtype=jnp.int32)
    rays = wavefront.raygen(rot, pos, fov, aspect, near, ids, 16, 16)
    z = jnp.int32(0)

    def counts(c):
        col, (box, tri) = jax.jit(
            lambda: wavefront.trace(
                cornell, rays, ids, z, z, c, with_heatmap=True
            )
        )()
        return np.asarray(col), np.asarray(box), np.asarray(tri)

    col2, box2, tri2 = counts(cfg.replace(bounce_limit=2))
    col6, box6, tri6 = counts(cfg.replace(bounce_limit=6))
    assert (box6 >= box2).all() and (tri6 >= tri2).all()
    assert box6.sum() > box2.sum()  # deeper paths really counted more

    # radiance parity with the plain fused integrator
    plain = np.asarray(
        jax.jit(
            lambda: wavefront.trace(
                cornell, rays, ids, z, z, cfg.replace(bounce_limit=6)
            )
        )()
    )
    np.testing.assert_allclose(col6, plain, rtol=1e-6, atol=1e-6)


def test_textured_render(tmp_path):
    """Albedo texture sampling (quirk Q1 capability): a textured quad must
    show spatial color variation; with textures disabled it must not."""
    from PIL import Image

    # 32x32 texture: a smooth gradient under a coarse checker
    yy, xx = np.mgrid[0:32, 0:32]
    tex = np.stack([xx * 8, yy * 8, ((xx // 8 + yy // 8) % 2) * 255], -1)
    Image.fromarray(tex.astype(np.uint8)).save(tmp_path / "t.png")
    (tmp_path / "m.mtl").write_text(
        "newmtl tex\nKd 1.0 1.0 1.0\nmap_Kd t.png\n"
    )
    (tmp_path / "quad.obj").write_text(
        "mtllib m.mtl\n"
        "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 -1 0\n"
        "usemtl tex\n"
        "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n"
    )
    b = SceneBuilder()
    b.add_obj(str(tmp_path / "quad.obj"), sampler=1)
    b.set_environment(Environment(enabled=True))
    scene = b.compile().device_put()
    cam = Camera(position=(0.0, -2.5, 0.0), angles_deg=(90.0, 0.0, 0.0))
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=1, bounce_limit=1)
    img = np.asarray(render_frame(scene, cfg, cam))
    flat = np.asarray(
        render_frame(scene, cfg.replace(enable_textures=False), cam)
    )
    assert np.isfinite(img).all()
    # Same seed => identical sampled paths, so textured/flat equals the
    # sampled albedo texture wherever the quad was hit: it must modulate.
    mask = flat.max(axis=-1) > 0.02
    assert mask.sum() > 20  # quad covers a good chunk of the frame
    ratio = img[mask] / np.maximum(flat[mask], 1e-6)
    assert ratio.min() < 0.9  # texture darkens somewhere
    assert ratio.std() > 0.05  # and varies spatially


def test_forest_mode_render_matches_flattened(cornell):
    """flatten_instances=False (reference per-object BVH forest semantics)
    must render the same image as the flattened default."""
    forest_scene = presets.default_scene().compile(
        flatten_instances=False
    ).device_put()
    a = np.asarray(render(cornell, CFG))
    b = np.asarray(render(forest_scene, CFG))
    np.testing.assert_allclose(a, b, atol=2e-4)


def test_binned_wavefront_bit_identical(cornell):
    """bin_rays permutes lanes but never changes any per-lane value.

    Counter-based RNG keyed on (pixel, sample, bounce) makes every sample
    permutation-invariant, so the binned + multi-phase-drain schedule must
    be BIT-identical to the plain path-regen wavefront.  Width 256*256
    also exercises the drain slicing (widths 65536 -> 16384).
    """
    import jax

    from ray_tracer_tpu.api import _camera_arrays, scene_camera

    cfg = RenderConfig(width=256, height=256)
    cam = scene_camera(cornell)
    rot, pos, fov, aspect, near = _camera_arrays(cam, cfg)
    ids = jnp.arange(256 * 256, dtype=jnp.int32)

    def run(bin_):
        c = cfg.replace(bin_rays=bin_)
        return jax.jit(
            lambda: wavefront.trace_wave(
                cornell, rot, pos, fov, aspect, near, ids, jnp.int32(0),
                jnp.int32(0), 1, c,
            )
        )()

    a = np.asarray(run(False))
    b = np.asarray(run(True))
    assert np.array_equal(a, b)


def test_bin_mode_leaf_bit_identical(cornell):
    """The leaf-id coherence key (Routing.bin_mode='leaf') is a pure
    re-permutation: images must match the morton key bit-exactly."""
    from ray_tracer_tpu import render
    from ray_tracer_tpu.config import Routing

    base = Routing(route="interpret")
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2,
                       bounce_limit=3, bin_rays=True, routing=base)
    a = np.asarray(render(cornell, cfg))
    b = np.asarray(render(
        cornell, cfg.replace(routing=base.replace(bin_mode="leaf"))
    ))
    assert np.array_equal(a, b)


def test_bin_mode_hier_bit_identical(cornell):
    """The hierarchical coherence key (Routing.bin_mode='hier': morton
    primary + prev-hit prim-id sub-order via two stable argsorts) is a
    pure re-permutation: images must match the morton key bit-exactly."""
    from ray_tracer_tpu import render
    from ray_tracer_tpu.config import Routing

    base = Routing(route="interpret")
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2,
                       bounce_limit=3, bin_rays=True, routing=base)
    a = np.asarray(render(cornell, cfg))
    b = np.asarray(render(
        cornell, cfg.replace(routing=base.replace(bin_mode="hier"))
    ))
    assert np.array_equal(a, b)


def test_drain_div_bit_identical(cornell):
    """The multi-phase drain divisor is pure scheduling: div=2 banks
    retired lanes in finer steps than div=4 but every lane's samples are
    computed by the same per-lane state machine — images must match
    bit-exactly (deaths happen in shading BEFORE the round's sort, so a
    slice never cuts a live lane; see trace_wave widths comment)."""
    import jax

    from ray_tracer_tpu.api import _camera_arrays, scene_camera

    cfg = RenderConfig(width=256, height=256)
    cam = scene_camera(cornell)
    rot, pos, fov, aspect, near = _camera_arrays(cam, cfg)
    ids = jnp.arange(256 * 256, dtype=jnp.int32)

    def run(div):
        c = cfg.replace(drain_div=div)
        return np.asarray(jax.jit(
            lambda: wavefront.trace_wave(
                cornell, rot, pos, fov, aspect, near, ids, jnp.int32(0),
                jnp.int32(0), 2, c,
            )
        )())

    assert np.array_equal(run(0), run(2))


def test_lane_pool_spp_split_matches(cornell):
    """The spp-lane population mode samples the identical estimator.

    lane_pool expansion splits each pixel's samples across g lanes
    (wavefront._lane_groups) purely to enlarge the wavefront population.
    The RNG
    streams are identical (keyed on (pixel, sample), both present either
    way), so the sampled paths are the same; the tolerance is the same
    float-scheduling allowance as test_tiling_invariance — the expanded
    lane count compiles a DIFFERENT XLA program whose reassociated FMAs
    drift per-sample values at ULP level, amplified to ~2e-4 through
    8 bounces of RR/MIS weighting (measured; a wrong path or stream
    would diverge at O(1)).
    """
    import jax

    from ray_tracer_tpu.api import _camera_arrays, scene_camera

    cfg = RenderConfig(width=64, height=64)
    cam = scene_camera(cornell)
    rot, pos, fov, aspect, near = _camera_arrays(cam, cfg)
    n = 64 * 64
    ids = jnp.arange(n, dtype=jnp.int32)

    def run(pool):
        c = cfg.replace(lane_pool=pool)
        return np.asarray(jax.jit(
            lambda: wavefront.trace_wave(
                cornell, rot, pos, fov, aspect, near, ids, jnp.int32(0),
                jnp.int32(0), 4, c,
            )
        )())

    seq = run(1)  # lanes = pixels: each lane regenerates 4 samples
    full = run(0)  # auto pool: g=4, one sample per lane
    np.testing.assert_allclose(full, seq, rtol=1e-3, atol=5e-4)
    half = run(2 * n)  # g=2, per-lane 2 samples
    np.testing.assert_allclose(half, seq, rtol=1e-3, atol=5e-4)
    # and the sampled paths must really be the same streams: the error
    # is ULP-accumulation small, far below one path's radiance
    assert np.abs(full - seq).max() < 1e-3
    assert np.mean(np.abs(full - seq)) < 1e-5


def test_ray_accounting_sem_vs_traced(cornell):
    """n_rays = [semantic, traced]: the semantic count
    matches the reference's per-ray traversal events (every bounce + every
    diffuse NEE ray, raytrace.comp:443,496); the traced count excludes
    facing-away NEE lanes resolved analytically.  Both integrators must
    agree (same per-lane state machine), with traced <= semantic and both
    at least the primary count."""
    import jax

    from ray_tracer_tpu.api import _camera_arrays, scene_camera

    cam = scene_camera(cornell)
    rot, pos, fov, aspect, near = _camera_arrays(cam, CFG)
    n = CFG.width * CFG.height
    ids = jnp.arange(n, dtype=jnp.int32)

    _, nr_wave = jax.jit(
        lambda: wavefront.trace_wave(
            cornell, rot, pos, fov, aspect, near, ids, jnp.int32(0),
            jnp.int32(0), 1, CFG, with_stats=True,
        )
    )()
    rays = wavefront.raygen(rot, pos, fov, aspect, near, ids,
                            CFG.width, CFG.height)
    _, nr_scan = jax.jit(
        lambda: wavefront.trace(
            cornell, rays, ids, jnp.int32(0), jnp.int32(0), CFG,
            with_stats=True,
        )
    )()
    nr_wave, nr_scan = np.asarray(nr_wave), np.asarray(nr_scan)
    assert nr_wave.shape == (2,) and nr_scan.shape == (2,)
    np.testing.assert_allclose(nr_wave, nr_scan)
    sem, traced = nr_wave
    assert n <= traced <= sem
    assert sem > n  # cornell diffuse bounces must have issued NEE rays


def test_estimator_ablation_variance_ordering(cornell):
    """Reproduces the reference's importance-sampling study
    (renders/importance_sampling/): at equal sample counts the estimator
    variance must order uniform > cosine > NEE+MIS on the Cornell box
    (small area light), and all three must agree in expectation."""
    import jax

    from ray_tracer_tpu.api import _camera_arrays, scene_camera

    cam = scene_camera(cornell)
    base = RenderConfig(width=24, height=24)
    rot, pos, fov, aspect, near = _camera_arrays(cam, base)
    ids = jnp.arange(24 * 24, dtype=jnp.int32)
    rays = wavefront.raygen(rot, pos, fov, aspect, near, ids, 24, 24)

    def renders(est, k=8):
        cfg = base.replace(estimator=est)
        f = jax.jit(
            lambda s: wavefront.trace(
                cornell, rays, ids, jnp.int32(0), s, cfg
            )
        )
        return np.stack([np.asarray(f(jnp.int32(s))) for s in range(k)])

    r = {est: renders(est) for est in ("uniform", "cosine", "mis")}
    # per-pixel variance across independent 1-spp estimates
    v = {est: np.var(x, axis=0).mean() for est, x in r.items()}
    assert v["uniform"] > v["cosine"] > v["mis"], v
    # unbiasedness: the k-sample means agree within noise
    m = {est: x.mean(axis=0) for est, x in r.items()}
    assert abs(m["cosine"].mean() - m["mis"].mean()) < 0.15
    assert abs(m["uniform"].mean() - m["mis"].mean()) < 0.15
