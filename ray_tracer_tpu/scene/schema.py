"""Declarative JSON scene format.

Replaces the reference's hardcoded scene code + ImGui-mutable state
(``prepare_storage_buffers``/``cornell_box``/``imgui_draw``,
``src/vk_engine.cpp:638-758,1492-1621``) with a serializable document.
Materials may be referenced by list index or by name.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Union

from .builder import SceneBuilder
from .types import Camera, Environment, Material


def _mat_index(b: SceneBuilder, names: Dict[str, int], ref: Union[int, str]) -> int:
    if isinstance(ref, str):
        return names[ref]
    return int(ref)


def builder_from_dict(doc: Dict[str, Any], base_dir: str = ".") -> SceneBuilder:
    b = SceneBuilder()
    names: Dict[str, int] = {}
    # Texture slots registered BEFORE objects: the serialized material
    # *_tex indices point into this prefix; MTL-ingested textures re-append
    # after it with consistently shifted indices on their own materials.
    for t in doc.get("textures", []):
        path = t if os.path.isabs(t) else os.path.join(base_dir, t)
        b.add_texture(path)
    for m in doc.get("materials", []):
        idx = b.add_material(
            Material(
                albedo=tuple(m.get("albedo", (1.0, 1.0, 1.0))),
                emission_color=tuple(m.get("emission_color", (0.0, 0.0, 0.0))),
                emission_strength=float(m.get("emission_strength", 0.0)),
                reflectance=float(m.get("reflectance", 0.0)),
                ior=float(m.get("ior", -1.0)),
                albedo_tex=int(m.get("albedo_tex", -1)),
                metalness_tex=int(m.get("metalness_tex", -1)),
                alpha_tex=int(m.get("alpha_tex", -1)),
                bump_tex=int(m.get("bump_tex", -1)),
                name=m.get("name", ""),
            )
        )
        if m.get("name"):
            names[m["name"]] = idx

    for s in doc.get("spheres", []):
        b.add_sphere(
            s["position"], s["radius"], _mat_index(b, names, s.get("material", 0))
        )

    for o in doc.get("objects", []):
        path = o["path"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        b.add_obj(
            path,
            material=_mat_index(b, names, o.get("material", 0)),
            position=tuple(o.get("position", (0, 0, 0))),
            rotation_deg=tuple(o.get("rotation_deg", (0, 0, 0))),
            scale=o.get("scale", (1.0, 1.0, 1.0)),
            front_only=bool(o.get("front_only", False)),
            sampler=int(o.get("sampler", 0)),
            name=o.get("name", ""),
        )

    for l in doc.get("lights", []):
        b.add_rect_light(
            corner=l["corner"],
            edge_u=l["edge_u"],
            edge_v=l["edge_v"],
            normal=l["normal"],
            material=_mat_index(b, names, l.get("material", 0)),
        )

    if "environment" in doc:
        e = doc["environment"]
        b.set_environment(
            Environment(
                horizon_color=tuple(e.get("horizon_color", (0.986, 1.0, 0.902))),
                sun_focus=float(e.get("sun_focus", 1000.0)),
                zenith_color=tuple(e.get("zenith_color", (0.265, 0.595, 0.887))),
                sun_intensity=float(e.get("sun_intensity", 10.0)),
                ground_color=tuple(e.get("ground_color", (0.431,) * 3)),
                light_dir=tuple(
                    e.get("light_dir", (0.5144958, 0.2057983, -0.7717437))
                ),
                enabled=bool(e.get("enabled", False)),
            )
        )

    if "camera" in doc:
        c = doc["camera"]
        b.set_camera(
            Camera(
                position=tuple(c.get("position", (0.0, -0.5, -3.5))),
                angles_deg=tuple(c.get("angles_deg", (4.0, 0.0, 0.0))),
                fov=float(c.get("fov", 50.0)),
                near_plane=float(c.get("near_plane", 0.1)),
            )
        )
    return b


def load_scene(path: str) -> SceneBuilder:
    with open(path) as f:
        doc = json.load(f)
    return builder_from_dict(doc, base_dir=os.path.dirname(os.path.abspath(path)))


def builder_to_dict(b: SceneBuilder) -> Dict[str, Any]:
    """Serialize a SceneBuilder back to the JSON document form.

    Mesh instances are emitted from the builder's recorded ``add_obj`` calls
    (path + TRS + flags); geometry itself is not embedded.  Post-hoc edits
    to individual ``InstanceDesc`` fields (e.g. repainting one usemtl
    group's material) are not captured — re-apply them after loading.
    """
    doc: Dict[str, Any] = {"materials": [], "spheres": [], "objects": [],
                           "lights": []}
    for call in b.obj_calls:
        doc["objects"].append(
            {
                "path": call["path"],
                "material": call["material"],
                "position": list(call["position"]),
                "rotation_deg": list(call["rotation_deg"]),
                "scale": list(call["scale"]),
                "front_only": call["front_only"],
                "sampler": call["sampler"],
                "name": call["name"],
            }
        )
    if b._texture_paths:
        # add_texture state (omitting it would silently round-trip
        # textured scenes to untextured ones)
        doc["textures"] = list(b._texture_paths)
    for m in b.materials:
        md = {
            "name": m.name,
            "albedo": list(m.albedo),
            "emission_color": list(m.emission_color),
            "emission_strength": m.emission_strength,
            "reflectance": m.reflectance,
            "ior": m.ior,
        }
        for attr in ("albedo_tex", "metalness_tex", "alpha_tex", "bump_tex"):
            if getattr(m, attr) >= 0:
                md[attr] = getattr(m, attr)
        doc["materials"].append(md)
    for s in b.spheres:
        doc["spheres"].append(
            {"position": list(s.position), "radius": s.radius,
             "material": s.material}
        )
    for l in b.lights:
        doc["lights"].append(
            {"corner": list(l.corner), "edge_u": list(l.edge_u),
             "edge_v": list(l.edge_v), "normal": list(l.normal),
             "material": l.material}
        )
    e = b.environment
    doc["environment"] = {
        "horizon_color": list(e.horizon_color), "sun_focus": e.sun_focus,
        "zenith_color": list(e.zenith_color), "sun_intensity": e.sun_intensity,
        "ground_color": list(e.ground_color), "light_dir": list(e.light_dir),
        "enabled": e.enabled,
    }
    c = b.camera
    doc["camera"] = {
        "position": list(c.position), "angles_deg": list(c.angles_deg),
        "fov": c.fov, "near_plane": c.near_plane,
    }
    return doc


def save_scene(b: SceneBuilder, path: str) -> None:
    with open(path, "w") as f:
        json.dump(builder_to_dict(b), f, indent=2)
