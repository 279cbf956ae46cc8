"""Sharded rendering tests on the 8-device virtual CPU mesh (SURVEY.md §4:
"multi-node without a cluster")."""

import numpy as np
import pytest
import jax

from ray_tracer_tpu import RenderConfig, render
from ray_tracer_tpu.parallel import mesh as pmesh
from ray_tracer_tpu.scene import presets

CFG = RenderConfig(width=32, height=32, samples_per_pixel=4, bounce_limit=3)


@pytest.fixture(scope="module")
def cornell():
    return presets.default_scene().compile()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_data_parallel_matches_single_device(cornell):
    m = pmesh.make_mesh(n_data=8, n_sample=1)
    sharded = np.asarray(pmesh.render_frame_sharded(cornell, CFG, m))
    single = np.asarray(render(cornell.device_put(), CFG))
    np.testing.assert_allclose(sharded, single, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_data_x_sample_mesh_matches(cornell):
    m = pmesh.make_mesh(n_data=4, n_sample=2)
    sharded = np.asarray(pmesh.render_frame_sharded(cornell, CFG, m))
    single = np.asarray(render(cornell.device_put(), CFG))
    # sample-axis split changes only the order of the 4-sample mean
    np.testing.assert_allclose(sharded, single, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sample_only_mesh(cornell):
    m = pmesh.make_mesh(n_data=1, n_sample=8)
    cfg = CFG.replace(samples_per_pixel=8)
    sharded = np.asarray(pmesh.render_frame_sharded(cornell, cfg, m))
    single = np.asarray(render(cornell.device_put(), cfg))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_data_parallel_packet_kernel(cornell):
    """The production multi-card configuration: shard_map + the Pallas
    walk kernel (interpreter on the CPU mesh) inside trace_wave, against
    the single-device gather walk."""
    from ray_tracer_tpu.config import Routing

    cfg = CFG.replace(routing=Routing(route="interpret"))
    m = pmesh.make_mesh(n_data=8, n_sample=1)
    sharded = np.asarray(pmesh.render_frame_sharded(cornell, cfg, m))
    single = np.asarray(render(cornell.device_put(), CFG))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_data_x_sample_mesh_kernel_binned(cornell):
    """The walk kernel composes with a (data, sample) mesh and with the
    binned wavefront (permutes + multi-phase drain) inside each shard."""
    from ray_tracer_tpu.config import Routing

    cfg = CFG.replace(routing=Routing(route="interpret"), bin_rays=True)
    m = pmesh.make_mesh(n_data=4, n_sample=2)
    sharded = np.asarray(pmesh.render_frame_sharded(cornell, cfg, m))
    single = np.asarray(render(cornell.device_put(), CFG))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_sharded_inputs_are_replicated(cornell, monkeypatch):
    """Camera arrays and the frame index reach every device of the mesh,
    not the default device alone (the four-card path)."""
    devs = jax.devices()[:4]
    m = pmesh.make_mesh(n_data=4, n_sample=1, devices=devs)
    seen = []
    orig = pmesh.make_sharded_render_fn

    def spy(mesh, cfg, spp):
        fn = orig(mesh, cfg, spp)

        def wrapped(*args):
            seen.extend(args)
            return fn(*args)

        return wrapped

    monkeypatch.setattr(pmesh, "make_sharded_render_fn", spy)
    img = pmesh.render_frame_sharded(
        cornell, RenderConfig(width=8, height=8, bounce_limit=1), m
    )
    assert img.shape == (8, 8, 3)
    for x in jax.tree.leaves(seen):
        assert set(x.devices()) == set(devs), x.sharding


def test_sharded_fn_compiled_once_per_mesh_and_config(cornell):
    """A second frame reuses the jitted program, and a scene replicated
    with ``replicate`` is not uploaded again."""
    m = pmesh.make_mesh(n_data=2, n_sample=1, devices=jax.devices()[:2])
    cfg = RenderConfig(width=8, height=6, bounce_limit=1)
    scene = pmesh.replicate(cornell, m)
    assert pmesh.replicate(scene, m).tri_packed is scene.tri_packed
    pmesh.make_sharded_render_fn.cache_clear()
    a = np.asarray(pmesh.render_frame_sharded(scene, cfg, m, frame=0))
    b = np.asarray(pmesh.render_frame_sharded(scene, cfg, m, frame=1))
    info = pmesh.make_sharded_render_fn.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert a.shape == b.shape == (6, 8, 3)
    assert not np.array_equal(a, b)  # the frame index reaches the RNG
