"""Compile-time scene validation with actionable errors.

The reference fails loudly at the API boundary (the ``VK_CHECK`` abort
macro, ``src/vk_engine.cpp:20-27``; hard ``exit(0)`` on a missing texture,
``src/vk_textures.cpp:114``).  This is the equivalent discipline for the
declarative scene layer: a malformed scene fails
at ``SceneBuilder.compile()`` with a message naming the offending entity,
instead of surfacing as a raw numpy IndexError deep in the flattener.
"""

from __future__ import annotations

import os

import numpy as np


class SceneValidationError(ValueError):
    """A scene references something that doesn't exist or isn't finite."""


def validate(b) -> None:
    """Raise :class:`SceneValidationError` on the first problem found."""
    n_mat = len(b.materials) or 1  # compile() defaults to one Material()
    n_tex = len(b._texture_paths)

    def mat_ok(idx, what):
        if not (0 <= int(idx) < n_mat):
            raise SceneValidationError(
                f"{what} references material {idx}, but the scene has "
                f"{n_mat} material(s) (indices 0..{n_mat - 1})"
            )

    for i, m in enumerate(b.materials):
        name = f"material {i}" + (f" ({m.name!r})" if m.name else "")
        for attr in ("albedo", "emission_color"):
            v = np.asarray(getattr(m, attr), np.float64)
            if v.shape != (3,) or not np.isfinite(v).all():
                raise SceneValidationError(
                    f"{name}: {attr} must be 3 finite numbers, got "
                    f"{getattr(m, attr)!r}"
                )
        for attr in ("emission_strength", "reflectance", "ior"):
            if not np.isfinite(getattr(m, attr)):
                raise SceneValidationError(
                    f"{name}: {attr} must be finite, got "
                    f"{getattr(m, attr)!r}"
                )
        for attr in ("albedo_tex", "metalness_tex", "alpha_tex", "bump_tex"):
            t = int(getattr(m, attr))
            if t >= n_tex:
                raise SceneValidationError(
                    f"{name}: {attr}={t} but only {n_tex} texture(s) are "
                    f"registered (add_texture / MTL maps)"
                )

    for i, p in enumerate(b._texture_paths):
        if not os.path.exists(p):
            raise SceneValidationError(
                f"texture {i}: file not found: {p}"
            )

    for i, s in enumerate(b.spheres):
        mat_ok(s.material, f"sphere {i}")
        pos = np.asarray(s.position, np.float64)
        if pos.shape != (3,) or not np.isfinite(pos).all():
            raise SceneValidationError(
                f"sphere {i}: position must be 3 finite numbers, got "
                f"{s.position!r}"
            )
        if not (np.isfinite(s.radius) and s.radius > 0):
            raise SceneValidationError(
                f"sphere {i}: radius must be finite and > 0, got "
                f"{s.radius!r}"
            )

    for i, (gid, inst) in enumerate(b.instances):
        mat_ok(
            inst.material,
            f"instance {i}" + (f" ({inst.name!r})" if inst.name else ""),
        )
        if not np.isfinite(np.asarray(inst.transform)).all():
            raise SceneValidationError(
                f"instance {i} ({inst.name!r}): non-finite transform "
                "(check position/rotation/scale)"
            )

    for gid, g in enumerate(b._groups):
        if not np.isfinite(g.positions).all():
            raise SceneValidationError(
                f"mesh group {gid}: non-finite vertex positions"
            )

    for i, l in enumerate(b.lights):
        mat_ok(l.material, f"light {i}")
        eu = np.asarray(l.edge_u, np.float64)
        ev = np.asarray(l.edge_v, np.float64)
        area = np.linalg.norm(np.cross(eu, ev))
        if not (np.isfinite(area) and area > 0):
            raise SceneValidationError(
                f"light {i}: degenerate rect (edge_u x edge_v area = "
                f"{area!r}); edges must span a nonzero parallelogram"
            )
        if b.materials and b.materials[l.material].emission_strength <= 0:
            raise SceneValidationError(
                f"light {i}: material {l.material} has emission_strength "
                f"{b.materials[l.material].emission_strength} — NEE light"
                " rects must reference an emissive material"
            )

    env = b.environment
    for attr in ("horizon_color", "zenith_color", "ground_color",
                 "light_dir"):
        if not np.isfinite(np.asarray(getattr(env, attr))).all():
            raise SceneValidationError(
                f"environment: non-finite {attr}"
            )

    cam = b.camera
    if not np.isfinite(
        np.asarray(tuple(cam.position) + tuple(cam.angles_deg)
                   + (cam.fov, cam.near_plane))
    ).all():
        raise SceneValidationError("camera: non-finite parameters")
    if not (0 < cam.fov < 180):
        raise SceneValidationError(
            f"camera: fov must be in (0, 180), got {cam.fov!r}"
        )
