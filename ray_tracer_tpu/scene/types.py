"""Scene description and compiled device-side scene arrays.

Host-side description objects mirror the reference's scene model
(``src/vk_engine.h:49-132``): spheres, materials, mesh instances with TRS
transforms, and a per-``usemtl``-group BVH forest.  ``CompiledScene`` is the
flat SoA pytree uploaded to the device — the replacement for the reference's
nine storage-buffer bindings (``shaders/raytrace.comp:120-148``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp


# --------------------------------------------------------------------------
# Host-side description
# --------------------------------------------------------------------------


@dataclass
class Material:
    """Mirrors reference ``RayMaterial`` (``src/vk_engine.h:69-79``)."""

    albedo: tuple = (1.0, 1.0, 1.0)
    emission_color: tuple = (0.0, 0.0, 0.0)
    emission_strength: float = 0.0
    reflectance: float = 0.0
    ior: float = -1.0  # -1 sentinel: not dielectric (vk_engine.h:74)
    albedo_tex: int = -1
    metalness_tex: int = -1
    alpha_tex: int = -1
    bump_tex: int = -1
    name: str = ""


@dataclass
class SphereDesc:
    """Mirrors reference ``Sphere`` (``src/vk_engine.h:49-53``)."""

    position: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0
    material: int = 0


@dataclass
class InstanceDesc:
    """One render object: a transform + material + BVH root.

    Mirrors reference ``RenderObject`` (``src/vk_engine.h:117-123``); one is
    emitted per ``usemtl`` group of a mesh (``src/vk_engine.cpp:960-1006``).
    """

    transform: np.ndarray  # (4,4) float32
    bvh_root: int
    material: int
    smooth_shade: bool = False
    sampler: int = 0  # 0 = nearest, 1 = bilinear
    name: str = ""


@dataclass
class RectLight:
    """Analytic NEE area light (replaces the hardcoded quad at
    ``shaders/raytrace.comp:368-403``).

    The rectangle is ``corner + u*su + v*sv`` for ``su, sv in [0,1)``;
    ``normal`` is the emitting face direction used for the PDF cosine.
    """

    corner: tuple
    edge_u: tuple
    edge_v: tuple
    normal: tuple
    material: int

    @property
    def area(self) -> float:
        return float(
            np.linalg.norm(np.cross(np.asarray(self.edge_u), np.asarray(self.edge_v)))
        )


@dataclass
class Environment:
    """Mirrors reference ``EnvironmentData`` (``src/vk_engine.h:153-158``)."""

    horizon_color: tuple = (0.986, 1.0, 0.902)
    sun_focus: float = 1000.0
    zenith_color: tuple = (0.265, 0.595, 0.887)
    sun_intensity: float = 10.0
    ground_color: tuple = (0.431, 0.431, 0.431)
    light_dir: tuple = (0.5144958, 0.2057983, -0.7717437)  # normalize(2,.8,-3)
    enabled: bool = False


@dataclass
class Camera:
    """Mirrors reference ``CameraInfo`` (``src/vk_engine.h:145-151``) plus the
    euler-angle state (``vk_engine.h:325``) used to build the rotation."""

    position: tuple = (0.0, -0.5, -3.5)
    angles_deg: tuple = (4.0, 0.0, 0.0)
    fov: float = 50.0
    near_plane: float = 0.1


# --------------------------------------------------------------------------
# Compiled device scene (pytree)
# --------------------------------------------------------------------------

N_OCTANTS = 8
SENTINEL = np.int32(2**31 - 1)  # traversal "done" link


@jax.tree_util.register_pytree_node_class
@dataclass
class CompiledScene:
    """Flat SoA arrays; the jit-traceable scene.

    Static (hashable) metadata lives in ``meta`` so recompiles only happen
    when array *shapes* change, not contents.
    """

    # Spheres (padded to a static count; radius 0 rows are inert).
    sphere_pos: Any  # (S,3) f32
    sphere_radius: Any  # (S,) f32
    sphere_mat: Any  # (S,) i32

    # Materials.
    mat_albedo: Any  # (M,3) f32
    mat_emission: Any  # (M,3) f32
    mat_emission_strength: Any  # (M,) f32
    mat_reflectance: Any  # (M,) f32
    mat_ior: Any  # (M,) f32
    mat_albedo_tex: Any  # (M,) i32
    mat_metalness_tex: Any  # (M,) i32
    mat_alpha_tex: Any  # (M,) i32
    mat_bump_tex: Any  # (M,) i32

    # Triangle geometry (BVH-reordered, global across all meshes).
    # Precomputed Moller-Trumbore operands (object space).
    tri_v0: Any  # (T,3) f32
    tri_e1: Any  # (T,3) f32  v1 - v0  ("v1v0" in raytrace.comp:229)
    tri_e2: Any  # (T,3) f32  v2 - v0
    tri_n: Any  # (T,3) f32   cross(e1, e2), geometric normal (unnormalized)
    tri_front_only: Any  # (T,) bool
    tri_obj: Any  # (T,) i32: owning instance (flattened scenes)
    # Vertex attributes for deferred shading (indexed by reordered tri id).
    tri_vn: Any  # (T,3,3) f32 vertex normals
    tri_uv: Any  # (T,3,2) f32 vertex uvs
    # Packed single-gather shade row (hot path): vn0|vn1|vn2 (9) |
    # uv0|uv1|uv2 (6) | degenerate-uv flag (1).  The degenerate test
    # (raytrace.comp:254-256) is per-triangle, so it is precomputed here.
    tri_shade: Any  # (T,16) f32
    # Fat shading rows: ONE gather per bounce replaces the tri_shade +
    # material-table + instance-table gathers.
    # Layout: 0-8 vn | 9-14 uv | 15 degen | 16-18 albedo |
    # 19-21 emission*strength | 22 reflectance | 23 ior | 24 albedo_tex |
    # 25 sampler | 26 material id | 27 instance id | 28 global tri id |
    # 29 metalness_tex | 30 alpha_tex | 31 bump_tex | 32-43 v0|e1|e2|n.
    shade_tri: Any  # (T,48) f32, indexed by global tri id

    # Instances.
    obj_transform: Any  # (O,4,4) f32
    obj_inv_transform: Any  # (O,4,4) f32 (precomputed; fixes quirk Q5)
    obj_bvh_root: Any  # (O,) i32
    obj_mat: Any  # (O,) i32
    obj_smooth: Any  # (O,) bool
    obj_sampler: Any  # (O,) i32

    # BVH forest, flat (reference node layout, vk_engine.h:185-189, split
    # into SoA) plus octant-threaded traversal links.
    bvh_min: Any  # (B,3) f32
    bvh_max: Any  # (B,3) f32
    bvh_index: Any  # (B,) i32: child pair start (interior) or tri start (leaf)
    bvh_tri_count: Any  # (B,) i32: 0 => interior
    bvh_axis: Any  # (B,) i32: split axis of interior nodes
    bvh_hit_link: Any  # (8,B) i32: next node if AABB hit & interior
    bvh_miss_link: Any  # (8,B) i32: next node if AABB missed / after leaf
    # Packed single-gather-row mirrors of the above (traversal hot path):
    bvh_packed: Any  # (B,8) f32: min3 | max3 | index (bitcast) | count (bitcast)
    links_packed: Any  # (8*B,2) i32: hit | miss, octant-major
    tri_packed: Any  # (T,16) f32: v0|e1|e2|n | front_only | obj (bitcast) | pad2

    # NEE lights.
    light_corner: Any  # (L,3) f32
    light_edge_u: Any  # (L,3) f32
    light_edge_v: Any  # (L,3) f32
    light_normal: Any  # (L,3) f32
    light_area: Any  # (L,) f32
    light_mat: Any  # (L,) i32

    # Environment (packed like the push constants, raytrace.comp:92-97).
    env_horizon: Any  # (4,) f32: rgb + sun focus
    env_zenith: Any  # (4,) f32: rgb + sun intensity
    env_ground: Any  # (3,) f32
    env_light_dir: Any  # (4,) f32: xyz + enabled

    # Textures: padded stack (K,H,W,3) uint8 sRGB + per-texture (h,w);
    # linearized at sample time (reference SRGB-view decode).
    tex_data: Any  # (K,Hmax,Wmax,3) u8
    tex_size: Any  # (K,2) i32

    # Static metadata (aux field of the pytree).
    meta: dict = field(default_factory=dict)

    _ARRAY_FIELDS = None  # populated below

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._ARRAY_FIELDS)
        return children, dict(self.meta)

    @classmethod
    def tree_unflatten(cls, aux, children):
        kw = dict(zip(cls._ARRAY_FIELDS, children))
        return cls(meta=dict(aux), **kw)

    @property
    def n_spheres(self) -> int:
        return self.meta.get("n_spheres", 0)

    @property
    def n_objects(self) -> int:
        return self.meta.get("n_objects", 0)

    @property
    def n_lights(self) -> int:
        return self.meta.get("n_lights", 0)

    @property
    def max_leaf_tris(self) -> int:
        return self.meta.get("max_leaf_tris", 2)

    def device_put(self, sharding=None) -> "CompiledScene":
        arrays, aux = self.tree_flatten()
        if sharding is None:
            arrays = [jax.device_put(jnp.asarray(a)) for a in arrays]
        else:
            arrays = [jax.device_put(jnp.asarray(a), sharding) for a in arrays]
        return self.tree_unflatten(aux, arrays)


CompiledScene._ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(CompiledScene) if f.name != "meta"
)
