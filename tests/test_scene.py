"""Scene compiler tests: OBJ/MTL parsing against the shipped Cornell meshes
(SURVEY.md §4: parser tests vs assets/cube.obj, test_plane.obj + its .mtl)."""

import os

import numpy as np
import pytest

from ray_tracer_tpu.scene import mtlio, objio, presets
from ray_tracer_tpu.scene.builder import SceneBuilder
from ray_tracer_tpu.scene.types import Material
from ray_tracer_tpu.utils.transforms import camera_rotation, trs_matrix


def test_parse_cube(assets_dir):
    mesh = objio.parse_obj(os.path.join(assets_dir, "cube.obj"))
    assert mesh.n_tris == 12  # triangulated cube
    assert len(mesh.groups) == 1
    g = mesh.groups[0]
    # all vertices on the unit cube
    assert np.all(np.abs(np.abs(g.positions) - 1.0) < 1e-6)
    # normals are unit axis vectors
    assert np.allclose(np.linalg.norm(g.normals, axis=-1), 1.0, atol=1e-4)


def test_parse_plane(assets_dir):
    mesh = objio.parse_obj(os.path.join(assets_dir, "plane.obj"))
    assert mesh.n_tris == 2
    g = mesh.groups[0]
    assert np.allclose(g.positions[:, :, 1], 0.0)  # y = 0 plane


def test_parse_test_plane_mtl(tmp_path):
    # a textured plane with its own MTL library, like the reference's
    # assets/test_plane.obj
    (tmp_path / "test_plane.mtl").write_text(
        "newmtl plane\nKa 1.0 1.0 1.0\nKd 0.8 0.5 0.2\nmap_Kd grid.png\n"
    )
    (tmp_path / "test_plane.obj").write_text(
        "mtllib test_plane.mtl\n"
        "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 -1 0\n"
        "usemtl plane\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
    )
    mesh = objio.parse_obj(str(tmp_path / "test_plane.obj"))
    assert mesh.mtl_path and os.path.exists(mesh.mtl_path)
    lib = mtlio.parse_mtl(mesh.mtl_path)
    assert len(lib.materials) >= 1
    # albedo = Ka * Kd per reference vk_engine.cpp:1100
    for m in lib.materials.values():
        assert all(0.0 <= c <= 1.0 for c in m.albedo)


def test_usemtl_grouping(tmp_path):
    p = tmp_path / "two.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
        "usemtl a\nf 1 2 3\nusemtl b\nf 1 2 4\nf 1 3 4\n"
    )
    mesh = objio.parse_obj(str(p))
    assert [g.positions.shape[0] for g in mesh.groups] == [1, 2]


def test_native_obj_twin_all_assets(assets_dir):
    """The native C++ scanner (scene/native_obj.py) must be BIT-identical
    to the Python parser on every shipped asset: same groups, material
    names, smooth flags, mtllib resolution, and float arrays (the scanner
    parses via strtod->f32 to match Python's float()->np.float32 double
    rounding)."""
    import glob

    from ray_tracer_tpu.scene import native_obj

    if not native_obj.available():
        pytest.skip("no native toolchain")
    assets = sorted(
        glob.glob(os.path.join(assets_dir, "**", "*.obj"), recursive=True)
    )
    assert assets
    for path in assets:
        a = objio._parse_obj_py(path)
        b = native_obj.parse_obj_native(path)
        assert b is not None, path
        assert (a.mtl_path or None) == (b.mtl_path or None), path
        assert len(a.groups) == len(b.groups), path
        for ga, gb in zip(a.groups, b.groups):
            assert ga.material == gb.material, path
            assert ga.smooth == gb.smooth, path
            assert np.array_equal(ga.positions, gb.positions), path
            assert np.array_equal(ga.normals, gb.normals), path
            assert np.array_equal(ga.uvs, gb.uvs), path


def test_native_obj_twin_edge_cases(tmp_path):
    """Synthetic stress: n-gon fans, negative (relative) indices, v//vn
    and v/vt forms, missing normals (geometric fallback), smooth toggles,
    first-usemtl special case, material names with spaces, mtllib."""
    from ray_tracer_tpu.scene import native_obj

    if not native_obj.available():
        pytest.skip("no native toolchain")
    p = tmp_path / "stress.obj"
    p.write_text(
        "# comment\n"
        "mtllib  my materials.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0.5 1\n"
        "vt 0.25\n"  # single-component vt
        "vn 0 0 1\nvn 0 1 0\n"
        "usemtl first mat\n"  # first-usemtl special case (no flush)
        "f 1/1/1 2/2/1 3/3/2\n"  # full v/vt/vn
        "f -5 -4 -3 -1\n"  # negative indices + quad fan, no vt/vn
        "s 1\n"
        "usemtl metal 2\n"
        "f 1//1 2//1 5//2\n"  # v//vn
        "f 1/4 2/1 3/2\n"  # v/vt, geometric normal fallback
        "s off\n"
        "f 2 3 5\n"
    )
    a = objio._parse_obj_py(str(p))
    b = native_obj.parse_obj_native(str(p))
    assert b is not None
    assert a.mtl_path == b.mtl_path
    assert [g.material for g in a.groups] == [g.material for g in b.groups]
    assert [g.smooth for g in a.groups] == [g.smooth for g in b.groups]
    assert a.n_tris == b.n_tris == 6  # 1 + quad fan(2) + 3
    for ga, gb in zip(a.groups, b.groups):
        assert np.array_equal(ga.positions, gb.positions)
        assert np.array_equal(ga.normals, gb.normals)
        assert np.array_equal(ga.uvs, gb.uvs)


def test_dedupe_reuses_bvh(assets_dir):
    b = SceneBuilder()
    b.add_material(Material())
    cube = os.path.join(assets_dir, "cube.obj")
    b.add_obj(cube, material=0, position=(0, 0, 0))
    b.add_obj(cube, material=0, position=(2, 0, 0))
    # forest mode: reference dedupe semantics (vk_engine.cpp:802-815)
    scene = b.compile(flatten_instances=False)
    assert scene.n_objects == 2
    assert int(scene.obj_bvh_root[0]) == int(scene.obj_bvh_root[1])
    assert scene.meta["n_tris"] == 12  # triangles stored once
    # flattened mode: instances baked to world space, one global BVH
    flat = b.compile(flatten_instances=True)
    assert flat.meta["n_tris"] == 24
    assert flat.meta["flattened"]


def test_default_scene_matches_reference_shape(assets_dir):
    scene = presets.default_scene(assets_dir).compile()
    # 2 cubes + light + 6 walls = 9 render objects (vk_engine.cpp:638-751)
    assert scene.n_objects == 9
    assert scene.meta["n_materials"] == 6
    # 2 cubes share one mesh: 12 + light 10(2 tris x5 faces? actual) ...
    # just sanity: all 6 cornell pieces present
    assert scene.meta["n_tris"] > 20
    assert scene.n_lights == 1
    np.testing.assert_allclose(np.asarray(scene.light_area), 4.0 / 9.0, rtol=1e-5)


def test_trs_matrix_translation_rotation():
    m = trs_matrix((1, 2, 3), (0, 90, 0), (1, 1, 1))
    np.testing.assert_allclose(m[:3, 3], [1, 2, 3], atol=1e-6)
    # Ry(90): +z -> +x  (standard right-handed rotation)
    v = m[:3, :3] @ np.array([0, 0, 1.0])
    np.testing.assert_allclose(v, [1, 0, 0], atol=1e-6)


def test_camera_rotation_identity_at_zero():
    np.testing.assert_allclose(camera_rotation((0, 0, 0)), np.eye(3), atol=1e-7)


def test_inverse_transform_precomputed(assets_dir):
    scene = presets.default_scene(assets_dir).compile()
    t = np.asarray(scene.obj_transform)
    inv = np.asarray(scene.obj_inv_transform)
    prod = np.einsum("oij,ojk->oik", t, inv)
    np.testing.assert_allclose(prod, np.tile(np.eye(4), (t.shape[0], 1, 1)), atol=1e-4)
