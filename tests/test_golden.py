"""Golden regression: renders frozen at a known-good revision.

The reference's de-facto acceptance artifacts are its renders/ PNGs
(SURVEY.md §4); these are the equivalent for this framework — small
deterministic CPU renders checked against committed float16 goldens.
Guards the integrator's radiometric semantics against drift.

Each golden is checked through both traversal routes: the XLA gather walk
(``Routing(route="walk")``, the oracle) and the Pallas walk kernel in the
interpreter (the kernel body the GPU compiles), so a kernel-vs-walk image
divergence fails the golden, not just the traversal-level equivalence
tests in test_walk_kernel.py.
"""

import os

import numpy as np
import pytest

from ray_tracer_tpu import RenderConfig, render
from ray_tracer_tpu.config import Routing
from ray_tracer_tpu.scene import presets

CFG = RenderConfig(width=40, height=40, samples_per_pixel=8, bounce_limit=6)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _bunny_scene():
    # mesh-BVH golden (908-face bunny decimation in the cornell box):
    # a traversal regression fails a render-level golden, not just the
    # traversal unit tests
    return presets.mesh_scene(
        "bunny.obj", material=presets.WHITE, scale=0.8,
        position=(0.0, 0.769, 0.0), rotation_deg=(0.0, 180.0, 0.0),
    )


def _textured_scene():
    # texture-sampling golden: the dread model with its albedo map
    # assigned via add_texture (reference quirk Q1's missing capability)
    return presets.dread_demo()


@pytest.mark.parametrize("route", ["walk", "interpret"])
@pytest.mark.parametrize(
    "name,builder",
    [
        ("cornell", presets.default_scene),
        ("cornell_spheres", presets.cornell_spheres),
        ("sphere_diffuse", presets.sphere_diffuse),
        ("bunny_mesh", _bunny_scene),
        ("dread_textured", _textured_scene),
    ],
)
def test_golden(name, builder, route):
    path = os.path.join(GOLDEN_DIR, f"{name}_40x40_8spp.npy")
    mesh = {"bunny_mesh": "bunny.obj", "dread_textured": "dread.obj"}.get(name)
    if mesh and not os.path.exists(os.path.join(presets.DEFAULT_ASSETS, mesh)):
        pytest.skip(f"{mesh} is not shipped; set RT_ASSETS to a directory "
                    "that holds it")
    golden = np.load(path).astype(np.float32)
    cfg = CFG.replace(routing=Routing(route=route))
    img = np.asarray(render(builder().compile().device_put(), cfg))
    # float16 quantization of the golden + cross-backend FMA noise
    np.testing.assert_allclose(img, golden, atol=2e-3)
