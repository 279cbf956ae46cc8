"""Gallery-reconstruction presets (tools/parity.py cases).

Every reference render that uses the reference's in-tree assets has a
reconstruction preset; these tests pin their structural facts (counts,
recorded material/camera values, material plumbing) so a preset edit that
silently diverges from the screenshot archaeology fails here instead of
only shifting a parity MSE.  The dragon_* renders remain waived (no dragon
mesh ships; PARITY.md).  Presets built on a gallery mesh that the package
does not ship (rb, dread, bobadog) skip unless ``RT_ASSETS`` names a
directory that holds it.
"""

import os

import numpy as np
import pytest

from ray_tracer_tpu import RenderConfig, render
from ray_tracer_tpu.scene import presets
from ray_tracer_tpu.scene.types import Camera, Material


def _needs(mesh):
    """Skip unless the gallery mesh ``mesh`` is in the asset directory."""
    if not os.path.exists(os.path.join(presets.DEFAULT_ASSETS, mesh)):
        pytest.skip(f"{mesh} is not shipped; set RT_ASSETS to a directory "
                    "that holds it")


def test_unlit_sphere_structure():
    b = presets.unlit_sphere()
    s = b.compile()
    assert s.n_lights == 0
    assert s.n_spheres == 1
    assert not b.environment.enabled
    glow = b.materials[b.spheres[0].material]
    assert glow.emission_strength > 0.0


def test_unlit_sphere_renders_white_on_black():
    # the earliest reference shot: emission credited at the primary hit
    # (raytrace.comp:500-505) on a black environment
    scene = presets.unlit_sphere().compile().device_put()
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=4,
                       bounce_limit=4)
    img = np.asarray(render(scene, cfg))
    assert img[12, 12].min() > 0.9  # sphere: emissive white
    assert img[1, 1].max() < 1e-3  # corner: black (env off)


def test_dielectrics_structure():
    b = presets.dielectrics()
    s = b.compile()
    assert s.n_spheres == 2
    assert s.n_lights == 1
    mats = [b.spheres[i].material for i in range(2)]
    assert presets.DIELECTRIC in mats and presets.RED in mats
    # default boot pose (green wall left in the screenshot)
    assert tuple(b.camera.position) == (0.0, -0.5, -3.5)


def test_sphere_reflectance_records_panel_material():
    # the screenshot's ImGui panel pins albedo (221,165,8) and
    # reflectance 0.85 — the one gallery case with recorded material
    b = presets.sphere_reflectance()
    gold = b.materials[b.spheres[1].material]
    np.testing.assert_allclose(
        gold.albedo, (221 / 255.0, 165 / 255.0, 8 / 255.0)
    )
    assert gold.reflectance == 0.85


def test_triangle_reflectance_structure():
    b = presets.triangle_reflectance()
    s = b.compile()
    assert s.n_spheres == 4
    # exactly one extra mesh: the single test triangle
    assert s.meta["n_tris"] == 1
    assert b.materials[b.spheres[3].material].reflectance != 0.0  # planet


def test_obj_normals_records_panel_camera():
    _needs("rb.obj")
    # the one gallery case with a RECORDED camera (fov 50, rot (4,-89,0),
    # pos (-3,-0.5,-1) in the screenshot's panel)
    b = presets.obj_normals_demo()
    assert tuple(b.camera.position) == (-3.0, -0.5, -1.0)
    assert tuple(b.camera.angles_deg) == (4.0, -89.0, 0.0)
    assert b.camera.fov == 50.0
    s = b.compile()
    assert s.meta["n_textures"] >= 1  # rb albedo map assigned


def test_obj_reflectance_structure():
    _needs("rb.obj")
    b = presets.obj_reflectance_demo()
    s = b.compile()
    assert s.n_spheres == 4  # planet scene
    # rb mesh + the floating 2-tri quad
    assert s.meta["n_tris"] > 1000


def test_rb_metallic_textured_mirror():
    _needs("rb.obj")
    b = presets.rb_metallic_demo()
    rb_mats = [
        b.materials[inst.material]
        for _, inst in b.instances
        if inst.name.startswith("rb")
    ]
    assert rb_mats, "rb instances present"
    assert all(m.reflectance != 0.0 and m.albedo_tex >= 0 for m in rb_mats)


@pytest.mark.parametrize("kind,reflectance,textured", [
    ("white", 0.0, False),
    ("metallic", 1.0, False),
    ("texture_metallic", 1.0, True),
])
def test_dread_variants(kind, reflectance, textured):
    _needs("dread.obj")
    b = presets.dread_demo(kind=kind)
    dread_mats = [
        b.materials[inst.material]
        for _, inst in b.instances
        if inst.name == "dread"
    ]
    assert dread_mats
    for m in dread_mats:
        assert m.reflectance == reflectance
        assert (m.albedo_tex >= 0) == textured


def test_mtlmap_solid_and_camera_override():
    _needs("rb.obj")
    b = presets.mtlmap_demo(
        "rb", solid=Material(ior=2.0, name="glass"), camera=Camera()
    )
    s = b.compile()
    assert s.meta["n_textures"] == 0  # solid variant loads no maps
    assert tuple(b.camera.position) == (0.0, -0.5, -3.5)  # default pose
    glass = [
        b.materials[inst.material]
        for _, inst in b.instances
        if inst.name == "rb"
    ]
    assert glass and all(m.ior == 2.0 for m in glass)


def test_bobadog_automatic_mtl_pipeline():
    _needs("bobadog/bobadog.obj")
    # README-featured model: the ONLY in-tree asset with a complete
    # obj+mtl+texture set — proves map_Ka ingestion and per-usemtl-group
    # MTL material resolution with zero manual assignment
    b = presets.bobadog_demo()
    s = b.compile()
    assert s.meta["n_textures"] >= 1  # bobaxture2.png via map_Ka
    dog_mats = [
        b.materials[inst.material]
        for _, inst in b.instances
        if inst.name == "bobadog"
    ]
    assert dog_mats
    assert any(m.albedo_tex >= 0 for m in dog_mats)  # Bobadog group
    assert s.meta["n_tris"] > 2000


def test_bobadog_renders():
    _needs("bobadog/bobadog.obj")
    scene = presets.bobadog_demo().compile().device_put()
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2,
                       bounce_limit=3)
    img = np.asarray(render(scene, cfg))
    assert np.isfinite(img).all() and img.mean() > 0.01
