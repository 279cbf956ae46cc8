"""Working height-map bump mapping (capability CLOSING quirk Q8).

The reference parses map_bump into a material slot and carries
tangent/binormal fields (``src/vk_engine.cpp:1127-1141``,
``vk_engine.h:64-67``) but ``calculate_binormal`` never writes its
outputs (``:1040-1058``) — bump mapping is dead there.  This renderer
implements it behind ``RenderConfig.enable_normal_maps`` (default False
= snapshot-exact): tangent frame solved from triangle edges + UV deltas
(exactly the system calculate_binormal intended), 3-tap per-texel
height gradient, normal perturbed by ``bump_scale``.
"""

import os
import tempfile

import numpy as np
import pytest

from ray_tracer_tpu import RenderConfig, render
from ray_tracer_tpu.config import Routing
from ray_tracer_tpu.scene.builder import SceneBuilder
from ray_tracer_tpu.scene.types import Camera, Environment, Material

CFG = RenderConfig(
    width=24, height=24, samples_per_pixel=8, bounce_limit=2,
    routing=Routing(route="walk"),
)


def _write_quad_obj(path, z=0.0, half=1.5, flip=False):
    """-z-facing quad (``flip``: +z-facing, winding matched)."""
    with open(path, "w") as f:
        f.write(
            f"v -{half} -{half} {z}\nv {half} -{half} {z}\n"
            f"v {half} {half} {z}\nv -{half} {half} {z}\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        )
        if flip:
            f.write(
                "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
                "f 1/1/1 2/2/2 3/3/3\nf 1/1/1 3/3/3 4/4/4\n"
            )
        else:
            f.write(
                "vn 0 0 -1\nvn 0 0 -1\nvn 0 0 -1\nvn 0 0 -1\n"
                "f 1/1/1 3/3/3 2/2/2\nf 1/1/1 4/4/4 3/3/3\n"
            )


def _write_gray_png(path, fn):
    from PIL import Image

    arr = np.zeros((16, 16, 3), np.uint8)
    for j in range(16):
        arr[:, j] = fn(j)
    Image.fromarray(arr).save(path)


@pytest.fixture
def tdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


def _scene(tdir, bump_fn):
    quad = os.path.join(tdir, "quad.obj")
    wall = os.path.join(tdir, "wall.obj")
    bmap = os.path.join(tdir, "b.png")
    _write_quad_obj(quad)
    # big +z-facing wall behind the camera: the 0/1-NEE delayed
    # accounting (raytrace.comp:500-505, reference-exact) resolves a
    # diffuse bounce's pending light only when the NEXT segment HITS
    # geometry, so an open scene would drop the quad's NEE entirely
    _write_quad_obj(wall, z=-3.2, half=9.0, flip=True)
    _write_gray_png(bmap, bump_fn)
    b = SceneBuilder()
    tex = b.add_texture(bmap)
    mat = b.add_material(Material(albedo=(0.8, 0.8, 0.8), bump_tex=tex))
    dark = b.add_material(Material(albedo=(0.25, 0.25, 0.25)))
    b.add_obj(quad, material=mat)
    b.add_obj(wall, material=dark)
    # rect light in FRONT of the quad but offset to +x, facing it: the
    # oblique l_dir has a +x component, so bump tilt along the tangent
    # (+-x) modulates cos(n, l) and therefore brightness
    glow = b.add_material(
        Material(emission_color=(1, 1, 1), emission_strength=6.0)
    )
    # light-normal convention follows the Cornell table (presets.py:99):
    # dot(normal, surface->light dir) > 0, i.e. normal points from the
    # lit side toward the light plane
    b.add_rect_light(
        (1.8, -0.6, -1.6), (0.6, 0.0, 0.0), (0.0, 1.2, 0.0),
        (0.0, 0.0, -1.0), glow,
    )
    b.set_environment(Environment(enabled=False))
    b.set_camera(Camera(position=(0, 0, -2.8), angles_deg=(0, 0, 0)))
    return b.compile().device_put()


def _quad_mean(img):
    return float(np.asarray(img)[8:16, 6:18].mean())


def test_bump_default_off_matches_flag_off(tdir):
    """enable_normal_maps defaults False: a scene WITH a bump texture
    renders bit-identically to the flag explicitly off (Q8 parity)."""
    sc = _scene(tdir, lambda j: j * 16)
    a = np.asarray(render(sc, CFG))
    b = np.asarray(render(sc, CFG.replace(enable_normal_maps=False)))
    assert np.array_equal(a, b)


def test_bump_constant_height_is_noop(tdir):
    """Zero gradient -> unperturbed normals -> identical image."""
    sc = _scene(tdir, lambda j: 128)
    a = np.asarray(render(sc, CFG))
    b = np.asarray(render(
        sc, CFG.replace(enable_normal_maps=True, bump_scale=4.0)
    ))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_bump_gradient_tilts_away_from_uphill(tdir):
    """A u-ramp height map (rising toward +x) tilts normals toward -x,
    darkening the quad under a +x light; the reversed ramp brightens it."""
    on = CFG.replace(enable_normal_maps=True, bump_scale=4.0)
    base = _quad_mean(render(_scene(tdir, lambda j: 128), on))
    uphill = _quad_mean(render(_scene(tdir, lambda j: j * 16), on))
    downhill = _quad_mean(render(_scene(tdir, lambda j: 240 - j * 16), on))
    assert uphill < base < downhill, (uphill, base, downhill)
    assert downhill > 1.05 * uphill, (uphill, downhill)


def test_bump_composes_with_kernel_route(tdir):
    """The bump path reads only shading-row fields, so the walk kernel
    route must match the gather-walk oracle exactly."""
    sc = _scene(tdir, lambda j: j * 16)
    on = CFG.replace(enable_normal_maps=True, bump_scale=4.0)
    a = np.asarray(render(sc, on))
    b = np.asarray(render(sc, on.replace(
        routing=Routing(route="interpret")
    )))
    np.testing.assert_allclose(a, b, atol=1e-6)
