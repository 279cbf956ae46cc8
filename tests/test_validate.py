"""Compile-time scene validation (the reference's VK_CHECK discipline,
src/vk_engine.cpp:20-27)."""

import numpy as np
import pytest

from ray_tracer_tpu.scene.builder import SceneBuilder
from ray_tracer_tpu.scene.types import Material
from ray_tracer_tpu.scene.validate import SceneValidationError


def test_bad_material_index_on_sphere():
    b = SceneBuilder()
    b.add_material(Material())
    b.add_sphere((0, 0, 0), 0.5, material=7)
    with pytest.raises(SceneValidationError, match="sphere 0.*material 7"):
        b.compile()


def test_bad_texture_index():
    b = SceneBuilder()
    b.add_material(Material(albedo_tex=3))
    with pytest.raises(SceneValidationError, match="albedo_tex=3"):
        b.compile()


def test_missing_texture_file():
    b = SceneBuilder()
    b.add_texture("/nonexistent/tex.png")
    b.add_material(Material(albedo_tex=0))
    with pytest.raises(SceneValidationError, match="file not found"):
        b.compile()


def test_negative_radius():
    b = SceneBuilder()
    b.add_material(Material())
    b.add_sphere((0, 0, 0), -1.0, material=0)
    with pytest.raises(SceneValidationError, match="radius"):
        b.compile()


def test_degenerate_light():
    b = SceneBuilder()
    m = b.add_material(Material(emission_strength=2.0))
    b.add_rect_light(corner=(0, 0, 0), edge_u=(1, 0, 0), edge_v=(2, 0, 0),
                     normal=(0, -1, 0), material=m)
    with pytest.raises(SceneValidationError, match="degenerate rect"):
        b.compile()


def test_non_emissive_light_material():
    b = SceneBuilder()
    m = b.add_material(Material(emission_strength=0.0))
    b.add_rect_light(corner=(0, 0, 0), edge_u=(1, 0, 0), edge_v=(0, 0, 1),
                     normal=(0, -1, 0), material=m)
    with pytest.raises(SceneValidationError, match="emissive"):
        b.compile()


def test_nan_albedo():
    b = SceneBuilder()
    b.add_material(Material(albedo=(float("nan"), 1.0, 1.0)))
    with pytest.raises(SceneValidationError, match="albedo"):
        b.compile()


def test_malformed_json_scene(tmp_path):
    """load_scene + compile of a bad document fails with a message, not a
    numpy stack trace."""
    import json

    from ray_tracer_tpu.scene import schema

    doc = {"materials": [{"name": "m"}],
           "spheres": [{"position": [0, 0, 0], "radius": 1, "material": 9}]}
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(doc))
    b = schema.load_scene(str(p))
    with pytest.raises(SceneValidationError, match="material 9"):
        b.compile()


def test_valid_scene_passes():
    from ray_tracer_tpu.scene import presets

    presets.default_scene().compile()  # no raise
