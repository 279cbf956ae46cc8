"""The Pallas walk kernel (kernels/walk_gpu.py) against the XLA gather walk.

On the CPU the kernel runs in the Pallas interpreter (``route="interpret"``),
which executes the same kernel body the GPU compiles; the gather walk
(``route="walk"``) is the oracle.  Also covered: the wrapper's padding,
the route resolution, the compile-cache directory choice, and that the
on-card entry points refuse to measure a CPU.
"""

import os
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ray_tracer_tpu.config import Routing
from ray_tracer_tpu.kernels import walk_gpu
from ray_tracer_tpu.ops import traverse
from ray_tracer_tpu.ops.intersect import BIG
from ray_tracer_tpu.scene import presets
from ray_tracer_tpu.scene.builder import SceneBuilder
from ray_tracer_tpu.scene.types import Material

WALK = Routing(route="walk")
INTERP = Routing(route="interpret")


def _soup_scene(rand, n_tris=300):
    tris = (
        rand.uniform(-2, 2, (n_tris, 1, 3))
        + rand.uniform(-0.4, 0.4, (n_tris, 3, 3))
    ).astype(np.float32)
    fd, path = tempfile.mkstemp(suffix=".obj")
    with os.fdopen(fd, "w") as f:
        for t in tris:
            for v in t:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(n_tris):
            f.write(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n")
    b = SceneBuilder()
    b.add_material(Material())
    b.add_obj(path, material=0, front_only=True)
    b.add_obj(path, material=0, position=(0.3, 0.2, 0.1), scale=1.1)
    scene = b.compile()
    os.unlink(path)
    return scene


_SCENES = {
    "cornell": lambda rand: presets.default_scene().compile(),
    "sponza_small": lambda rand: presets.sponza_proxy(6000).compile(),
    "soup": _soup_scene,
}
_SCENE_CACHE = {}


def _scene(name, rand):
    if name not in _SCENE_CACHE:
        _SCENE_CACHE[name] = _SCENES[name](rand).device_put()
    return _SCENE_CACHE[name]


def _rays(scene, rand, n=384, masked=False):
    """Rays from random points inside the scene's bounds; with ``masked``
    a third of the lanes are inactive and the rest carry a random tmax."""
    root = np.asarray(scene.bvh_packed[scene.meta["bvh_root"]])
    lo, hi = root[0:3], root[3:6]
    o = rand.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axis = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [0.6, 0.0, -0.8]]
    d[:4] = axis[:n]  # rays with zero direction components
    active = np.ones(n, bool)
    tmax = np.full(n, BIG, np.float32)
    if masked:
        active = rand.uniform(size=n) > 0.33
        tmax = rand.uniform(0.05, 0.5, n).astype(np.float32) * float(
            np.linalg.norm(hi - lo)
        )
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), jnp.asarray(
        tmax
    )


CASES = [
    ("cornell", False), ("sponza_small", False), ("soup", False),
    ("soup", True),
]


@pytest.mark.parametrize("name,masked", CASES,
                         ids=["cornell", "sponza_small", "soup", "soup_tmax"])
def test_closest_hit_matches_walk(name, masked, rand):
    scene = _scene(name, rand)
    o, d, act, tmax = _rays(scene, rand, masked=masked)
    ref = traverse.traverse(scene, o, d, act, tmax=tmax, routing=WALK)
    got = traverse.traverse(scene, o, d, act, tmax=tmax, routing=INTERP)
    np.testing.assert_array_equal(np.asarray(got.kind), np.asarray(ref.kind))
    hit = np.asarray(ref.kind) == traverse.KIND_TRI
    assert hit.sum() > 20
    np.testing.assert_array_equal(
        np.asarray(got.prim)[hit], np.asarray(ref.prim)[hit]
    )
    np.testing.assert_array_equal(
        np.asarray(got.obj)[hit], np.asarray(ref.obj)[hit]
    )
    np.testing.assert_allclose(
        np.asarray(got.dst), np.asarray(ref.dst), rtol=1e-6
    )
    # u/v/front are re-derived from the winning triangle row
    for f in ("u", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f))[hit], np.asarray(getattr(ref, f))[hit],
            rtol=1e-5, atol=1e-6,
        )
    np.testing.assert_array_equal(
        np.asarray(got.front)[hit], np.asarray(ref.front)[hit]
    )
    assert not np.asarray(got.kind)[~np.asarray(act)].any()


@pytest.mark.parametrize("name,masked", CASES,
                         ids=["cornell", "sponza_small", "soup", "soup_tmax"])
def test_anyhit_matches_walk(name, masked, rand):
    scene = _scene(name, rand)
    o, d, act, tmax = _rays(scene, rand, masked=masked)
    if not masked:  # occlusion queries always carry a finite radius
        tmax = jnp.full_like(tmax, 1.5)
    ref = np.asarray(traverse.traverse_anyhit(scene, o, d, act, tmax, WALK))
    got = np.asarray(traverse.traverse_anyhit(scene, o, d, act, tmax, INTERP))
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < ref.size
    assert not got[~np.asarray(act)].any()


@pytest.mark.parametrize("n", [1, 127, 130])
def test_wrapper_pads_to_whole_blocks(n, rand):
    """Ray counts that are not a multiple of the block are padded with
    inactive lanes; results come back at the caller's length."""
    scene = _scene("cornell", rand)
    o, d, act, tmax = _rays(scene, rand, n=n)
    tmax0 = jnp.where(act, tmax, -BIG)
    dst, prim = walk_gpu.walk_traverse(
        scene.bvh_packed, scene.tri_packed, scene.links_packed, o, d, tmax0,
        root=scene.meta["bvh_root"], max_leaf=scene.max_leaf_tris,
        interpret=True,
    )
    assert dst.shape == (n,) and prim.shape == (n,)
    ref = traverse.traverse(scene, o, d, act, routing=WALK)
    want = np.where(np.asarray(ref.kind) == traverse.KIND_TRI,
                    np.asarray(ref.prim), -1)
    np.testing.assert_array_equal(np.asarray(prim), want)


def test_inactive_lanes_skip_the_walk(rand):
    scene = _scene("cornell", rand)
    o, d, _, _ = _rays(scene, rand, n=64)
    dst, prim = walk_gpu.walk_traverse(
        scene.bvh_packed, scene.tri_packed, scene.links_packed, o, d,
        jnp.full((64,), -BIG), root=scene.meta["bvh_root"],
        max_leaf=scene.max_leaf_tris, interpret=True,
    )
    assert (np.asarray(prim) == -1).all()
    assert (np.asarray(dst) == -BIG).all()


def test_kernel_lowers_for_the_gpu(rand):
    """The kernel's Triton lowering runs on any host (compiling it needs
    the card): every primitive in the kernel body has a GPU lowering."""
    scene = _scene("cornell", rand)
    o, d, act, tmax = _rays(scene, rand, n=256)
    for anyhit in (False, True):
        lowered = jax.jit(
            lambda *a, anyhit=anyhit: walk_gpu.walk_traverse(
                *a, root=scene.meta["bvh_root"],
                max_leaf=scene.max_leaf_tris, anyhit=anyhit,
            )
        ).trace(
            scene.bvh_packed, scene.tri_packed, scene.links_packed, o, d, tmax
        ).lower(lowering_platforms=("cuda",))
        assert "triton" in lowered.as_text()


def test_route_resolution_on_cpu(rand):
    """auto = the gather walk off the GPU; the interpreter and the kernel
    run only when named; forest scenes always walk."""
    flat = _scene("cornell", rand)
    assert jax.default_backend() == "cpu"
    assert traverse.resolve_route(flat, Routing()) == "walk"
    assert traverse.resolve_route(flat, WALK) == "walk"
    assert traverse.resolve_route(flat, INTERP) == "interpret"
    assert traverse.resolve_route(flat, Routing(route="kernel")) == "kernel"
    forest = presets.default_scene().compile(flatten_instances=False)
    assert traverse.resolve_route(forest, INTERP) == "walk"
    with pytest.raises(ValueError):
        Routing(route="packet")


def test_route_from_env(monkeypatch):
    monkeypatch.setenv("RT_ROUTE", "interpret")
    monkeypatch.setenv("RT_BIN_MODE", "hier")
    rt = Routing.from_env()
    assert rt.route == "interpret" and rt.bin_mode == "hier"
    monkeypatch.delenv("RT_ROUTE")
    assert Routing.from_env().route == "auto"


def test_compile_cache_dir_choice(monkeypatch):
    from ray_tracer_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        jax.config.update("jax_compilation_cache_dir", before)
        assert cache.enable_compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before  # untouched
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = cache.enable_compile_cache()
        assert path == os.path.join(cache.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # inside the checkout, next to the package
        assert os.path.isdir(os.path.join(cache.CHECKOUT, "ray_tracer_tpu"))
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu(capsys):
    """No CPU fallback: on a CPU backend the smoke test exits non-zero and
    prints no result line."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_phases_on_cpu(capsys):
    """The smoke test's traversal check (the kernel in the interpreter) and
    its sharded check (four virtual devices) pass at a tiny size."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    scene = chip_smoke.setup_bench_scene("sponza_proxy:2000")
    chip_smoke.traversal_check(scene, 16, 12, kernel="interpret")
    chip_smoke.sharded_check(presets.sponza_proxy(2000).compile(), 16, 8)
    out = capsys.readouterr().out
    assert out.count("PASS") == 9 and "Traceback" not in out


def test_bench_refuses_cpu(capsys):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import bench

    assert bench.main() != 0
    assert capsys.readouterr().out == ""
