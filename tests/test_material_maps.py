"""Metalness/alpha texture-map shading (capability extension of quirk Q1).

The reference host plumbs map_Ks -> metalness and map_d -> alpha slots
(``src/vk_engine.cpp:1109-1141``) that the snapshot shader never samples;
its gallery (renders/rb_mtlmap.png, squeezer_mtlmap.png) proves an earlier
shader consumed them.  These tests pin the implemented semantics:
metalness.red replaces ``reflectance`` (bright texels -> mirror lobe);
alpha.red < 0.5 is a cutout (surface skipped, pass-through).
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
    width=24, height=24, samples_per_pixel=4, bounce_limit=3,
    routing=Routing(route="walk"),
)


def _write_quad_obj(path, z=0.0, half=1.5):
    """A z-facing quad spanning [-half, half]^2 with full uv coverage."""
    with open(path, "w") as f:
        f.write(
            f"v -{half} -{half} {z}\nv {half} -{half} {z}\n"
            f"v {half} {half} {z}\nv -{half} {half} {z}\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
            "vn 0 0 -1\nvn 0 0 -1\nvn 0 0 -1\nvn 0 0 -1\n"
            # winding chosen so the geometric normal (cross(e1,e2))
            # agrees with the -z vertex normals
            "f 1/1/1 3/3/3 2/2/2\nf 1/1/1 4/4/4 3/3/3\n"
        )


def _write_half_png(path, left, right):
    """16x16 grayscale PNG: left half = ``left``, right half = ``right``."""
    from PIL import Image

    arr = np.zeros((16, 16, 3), np.uint8)
    arr[:, :8] = left
    arr[:, 8:] = right
    Image.fromarray(arr).save(path)


@pytest.fixture
def tdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


def test_alpha_cutout_passes_through(tdir):
    """Left (alpha 0) shows the emissive wall behind; right (alpha 255)
    shows the dark quad."""
    quad = os.path.join(tdir, "quad.obj")
    wall = os.path.join(tdir, "wall.obj")
    amap = os.path.join(tdir, "a.png")
    _write_quad_obj(quad, z=0.0)
    _write_quad_obj(wall, z=2.0, half=4.0)
    _write_half_png(amap, 0, 255)

    b = SceneBuilder()
    tex = b.add_texture(amap)
    dark = b.add_material(Material(albedo=(0.05, 0.05, 0.05), alpha_tex=tex))
    glow = b.add_material(
        Material(emission_color=(1, 1, 1), emission_strength=3.0)
    )
    b.add_obj(quad, material=dark)
    b.add_obj(wall, material=glow)
    b.set_environment(Environment(enabled=False))
    b.set_camera(Camera(position=(0, 0, -4), angles_deg=(0, 0, 0)))
    img = np.asarray(render(b.compile().device_put(), CFG))
    # compare only columns INSIDE the quad's screen footprint (the quad
    # spans +-1.5 at z=0 from a z=-4 camera; beyond its edge every pixel
    # sees the wall)
    left = img[8:16, 3:11].mean()
    right = img[8:16, 13:21].mean()
    # cutout side sees the glowing wall; solid side is near-black
    assert left > 0.5, (left, right)
    assert right < 0.15, (left, right)
    assert left > 5 * right


def test_metalness_map_drives_reflectance(tdir):
    """Camera-facing quad under the environment light: the mirror half
    (metalness 255) reflects the sky at full, untinted brightness
    (snapshot-exact vec3(1) secondary lobe); the diffuse half is a dark
    0.1-albedo surface."""
    quad = os.path.join(tdir, "quad.obj")
    mmap = os.path.join(tdir, "m.png")
    _write_quad_obj(quad, z=0.0)
    _write_half_png(mmap, 0, 255)

    b = SceneBuilder()
    tex = b.add_texture(mmap)
    b.add_material(Material(albedo=(0.1, 0.1, 0.1), metalness_tex=tex))
    b.add_obj(quad, material=0)
    b.set_environment(Environment(enabled=True))
    b.set_camera(Camera(position=(0, 0, -4), angles_deg=(0, 0, 0)))
    img = np.asarray(render(b.compile().device_put(), CFG))
    left = img[8:16, 3:11].mean()   # metalness 0 -> dark diffuse
    right = img[8:16, 13:21].mean()  # metalness 1 -> mirror of the sky
    assert right > 2 * left, (left, right)
    assert right > 0.3, (left, right)


def test_maps_roundtrip_via_schema(tdir):
    """save_scene/load_scene keeps texture paths and *_tex indices
    (textured scenes must not silently round-trip untextured)."""
    from ray_tracer_tpu.scene import schema

    quad = os.path.join(tdir, "quad.obj")
    amap = os.path.join(tdir, "a.png")
    _write_quad_obj(quad)
    _write_half_png(amap, 0, 255)
    b = SceneBuilder()
    tex = b.add_texture(amap)
    b.add_material(Material(albedo_tex=tex, metalness_tex=tex))
    b.add_obj(quad, material=0)
    path = os.path.join(tdir, "scene.json")
    schema.save_scene(b, path)
    b2 = schema.load_scene(path)
    assert b2._texture_paths[:1] == [os.path.abspath(amap)]
    assert b2.materials[0].albedo_tex == 0
    assert b2.materials[0].metalness_tex == 0
    sc = b2.compile()
    assert sc.meta["n_metalness_maps"] == 1
