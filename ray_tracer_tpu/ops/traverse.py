"""Scene traversal: stackless octant-threaded BVH walk.

Replacement for ``calculateIntersections`` (``shaders/raytrace.comp:
276-353``).  Design differences from the GLSL megakernel:

* The reference keeps a 64-deep *per-thread* stack.  Here each ray instead
  carries a single node pointer through one of 8 precomputed
  near-child-first DFS threadings (selected by the ray's direction octant)
  -- see :mod:`ray_tracer_tpu.accel.bvh` -- so a ray's whole walk state is
  one integer plus its best hit.
* Two implementations of that walk: :func:`_walk`, batched XLA gathers
  under a ``lax.while_loop`` (runs anywhere; the correctness oracle), and
  the Pallas kernel :mod:`ray_tracer_tpu.kernels.walk_gpu`, one ray per GPU
  thread with the walk state in registers.  ``Routing.route`` picks one
  (:func:`resolve_route`).
* Object transforms are applied with *precomputed* inverse matrices (the
  reference recomputes ``inverse(transformMatrix)`` twice per object per ray,
  quirk Q5, ``raytrace.comp:292-293``).
* Like the reference, ``t`` is parametric in world units (object-space
  directions are deliberately NOT renormalized), so hit distances compare
  across objects and spheres directly.

Flattened scenes (the default) hold one world-space BVH.  Forest scenes
mirror the reference's per-object BVH forest (quirk Q11): a ``lax.scan``
over instances, carrying the running closest hit so the ``dst < closest``
prune sees earlier objects' hits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import Routing
from ..scene.types import CompiledScene
from . import intersect
from .intersect import BIG


def resolve_route(scene: CompiledScene, routing: Routing = None) -> str:
    """'walk' | 'kernel' | 'interpret': the triangle traversal to trace.

    ``auto`` takes the walk kernel on a GPU backend and the XLA gather walk
    elsewhere; the interpreter runs only when a caller names it.  Forest
    (non-flattened) scenes always take the gather walk.  A kernel that
    fails to compile is an error, never a silent fallback to the walk.
    """
    rt = routing if routing is not None else Routing.from_env()
    if not scene.meta.get("flattened", False):
        return "walk"
    if rt.route == "auto":
        return "kernel" if jax.default_backend() == "gpu" else "walk"
    return rt.route


# numpy scalar: module-level jnp constants would initialize the default
# backend at import time, breaking later jax_platforms overrides (--cpu)
SENTINEL = np.int32(2**31 - 1)

KIND_NONE = 0
KIND_SPHERE = 1
KIND_TRI = 2


class Hit(NamedTuple):
    """Closest-hit record (SoA over the ray batch).

    ``u``/``v`` are Moller-Trumbore barycentrics for deferred attribute
    interpolation (``hit = w*A0 + u*A1 + v*A2``); ``prim`` is the sphere or
    global triangle index; ``obj`` the instance index for triangles.
    """

    dst: jnp.ndarray  # (N,) f32, BIG when no hit
    kind: jnp.ndarray  # (N,) i32: 0 none / 1 sphere / 2 triangle
    prim: jnp.ndarray  # (N,) i32
    obj: jnp.ndarray  # (N,) i32
    u: jnp.ndarray  # (N,) f32
    v: jnp.ndarray  # (N,) f32
    front: jnp.ndarray  # (N,) bool

    @property
    def did_hit(self):
        return self.kind != KIND_NONE


def _transform_point(inv_m, p):
    # (N,4,4) x (N,3); full float32 (a GPU may otherwise run it in TF32)
    return (
        jnp.einsum("nij,nj->ni", inv_m[:, :3, :3], p,
                   precision=jax.lax.Precision.HIGHEST)
        + inv_m[:, :3, 3]
    )


def _transform_dir(inv_m, d):
    return jnp.einsum("nij,nj->ni", inv_m[:, :3, :3], d,
                      precision=jax.lax.Precision.HIGHEST)


def _kernel_hits(scene, origin, direction, tmax0, route, anyhit):
    """(dst, prim) from the walk kernel; prim = -1 where no triangle hit."""
    from ..kernels import walk_gpu

    return walk_gpu.walk_traverse(
        scene.bvh_packed, scene.tri_packed, scene.links_packed,
        origin, direction, tmax0,
        root=scene.meta["bvh_root"], max_leaf=scene.max_leaf_tris,
        anyhit=anyhit, interpret=route == "interpret",
    )


def traverse(
    scene: CompiledScene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    active: jnp.ndarray,
    max_steps: int = None,
    tmax: jnp.ndarray = None,
    raw: bool = False,
    routing: Routing = None,
    need_uv: bool = True,
) -> Hit:
    """Closest hit for a batch of world-space rays.

    ``active`` masks lanes; inactive lanes return no-hit without traversal
    work (their node pointer starts at the sentinel).

    ``tmax`` (optional, (N,)): per-lane search radius.  Hits beyond it are
    not found (lanes report no-hit; ``dst`` stays at the initial bound).
    Used to clip NEE shadow rays at the sampled light distance, which
    prunes every BVH subtree beyond the light.

    ``raw``: on the kernel route, skip the triangle -> instance gather;
    ``obj`` is then unset (0) for triangle hits -- hot callers read the
    instance from the fat shading row instead.

    ``max_steps`` bounds the gather walk's node visits; the default scales
    with the scene (each node is visited at most once per rope walk, so
    ``n_nodes + 1`` can never truncate a legitimate walk).

    ``need_uv=False``: the kernel route skips producing ``u``/``v``/
    ``front`` for triangle hits (they return zeros) -- hot callers
    re-derive them from the winning triangle's geometry inside the fat
    shading-row gather (``wavefront._shade_fetch``).  Sphere facing bits
    are unaffected.
    """
    n = origin.shape[0]
    n_nodes = scene.bvh_index.shape[0]
    if max_steps is None:
        max_steps = n_nodes + 1

    best = Hit(
        dst=jnp.full((n,), BIG) if tmax is None else jnp.asarray(tmax),
        kind=jnp.zeros((n,), jnp.int32),
        prim=jnp.zeros((n,), jnp.int32),
        obj=jnp.zeros((n,), jnp.int32),
        u=jnp.zeros((n,)),
        v=jnp.zeros((n,)),
        front=jnp.zeros((n,), bool),
    )

    # ---- spheres: brute force over the (small, padded) sphere table,
    # mirroring the reference's linear loop (raytrace.comp:282-287).
    if scene.n_spheres > 0:
        s_dst, s_front, s_hit = intersect.intersect_spheres(
            origin, direction, scene.sphere_pos, scene.sphere_radius
        )
        s_dst = jnp.where(s_hit, s_dst, BIG)
        si = jnp.argmin(s_dst, axis=1)
        sd = jnp.take_along_axis(s_dst, si[:, None], axis=1)[:, 0]
        sf = jnp.take_along_axis(s_front, si[:, None], axis=1)[:, 0]
        better = active & (sd < best.dst)
        best = Hit(
            dst=jnp.where(better, sd, best.dst),
            kind=jnp.where(better, KIND_SPHERE, best.kind),
            prim=jnp.where(better, si.astype(jnp.int32), best.prim),
            obj=best.obj,
            u=best.u,
            v=best.v,
            front=jnp.where(better, sf, best.front),
        )

    if scene.n_objects == 0 or scene.meta.get("n_tris", 0) == 0:
        return best

    route = resolve_route(scene, routing)
    if route != "walk":
        tmax0 = jnp.where(active, best.dst, -BIG)
        dst, prim = _kernel_hits(
            scene, origin, direction, tmax0, route, anyhit=False
        )
        tri_hit = prim >= 0
        ti = jnp.maximum(prim, 0)
        if need_uv:
            trow = scene.tri_packed[ti]
            _, u, v, _, front, _ = intersect.intersect_tris(
                origin, direction, trow[:, 0:3], trow[:, 3:6],
                trow[:, 6:9], trow[:, 9:12], trow[:, 12] > 0.5,
            )
        else:
            zero = jnp.zeros_like(dst)
            u, v, front = zero, zero, jnp.zeros_like(tri_hit)
        owner = jnp.zeros_like(prim) if raw else scene.tri_obj[ti]
        return Hit(
            dst=jnp.where(tri_hit, dst, best.dst),
            kind=jnp.where(tri_hit, KIND_TRI, best.kind),
            prim=jnp.where(tri_hit, prim, best.prim),
            obj=jnp.where(tri_hit, owner, best.obj),
            u=jnp.where(tri_hit, u, best.u),
            v=jnp.where(tri_hit, v, best.v),
            front=jnp.where(tri_hit, front, best.front),
        )

    hit_links = scene.bvh_hit_link.reshape(-1)  # (8*B,)
    miss_links = scene.bvh_miss_link.reshape(-1)
    if scene.meta.get("flattened", False):
        # Single world-space BVH: one walk, no transforms, no object loop.
        return _walk(
            scene, hit_links, miss_links, origin, direction, active, best,
            root=scene.obj_bvh_root[0], obj_id=None, max_steps=max_steps,
        )

    def per_object(best, obj_params):
        inv_m, root, obj_id = obj_params
        inv_b = jnp.broadcast_to(inv_m, (n, 4, 4))
        o = _transform_point(inv_b, origin)
        d = _transform_dir(inv_b, direction)
        best = _walk(
            scene, hit_links, miss_links, o, d, active, best,
            root=root, obj_id=obj_id, max_steps=max_steps,
        )
        return best, None

    obj_ids = jnp.arange(scene.obj_bvh_root.shape[0], dtype=jnp.int32)
    best, _ = jax.lax.scan(
        per_object,
        best,
        (scene.obj_inv_transform, scene.obj_bvh_root, obj_ids),
    )
    return best


def traverse_anyhit(
    scene: CompiledScene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    active: jnp.ndarray,
    tmax: jnp.ndarray,
    routing: Routing = None,
) -> jnp.ndarray:
    """Occlusion query: is there ANY hit strictly inside ``tmax``?

    On the kernel route lanes terminate at their first accepted hit; the
    gather walk derives occlusion from the closest hit, which is
    equivalent (a closest hit inside ``tmax`` exists iff any hit does).

    Returns (N,) bool; inactive lanes report unoccluded.
    """
    occ = jnp.zeros((origin.shape[0],), bool)

    # Spheres: brute-force loop, same as traverse().
    if scene.n_spheres > 0:
        s_dst, _, s_hit = intersect.intersect_spheres(
            origin, direction, scene.sphere_pos, scene.sphere_radius
        )
        s_dst = jnp.where(s_hit, s_dst, BIG)
        occ = occ | (jnp.min(s_dst, axis=1) < tmax)

    if scene.n_objects == 0 or scene.meta.get("n_tris", 0) == 0:
        return occ & active

    route = resolve_route(scene, routing)
    if route != "walk":
        tmax0 = jnp.where(active, tmax, -BIG)
        _, prim = _kernel_hits(
            scene, origin, direction, tmax0, route, anyhit=True
        )
        return (occ | (prim >= 0)) & active

    hit = traverse(scene, origin, direction, active, tmax=tmax, routing=routing)
    return (occ | (hit.kind == KIND_TRI)) & active


def traverse_with_stats(scene, origin, direction, active, tmax=None):
    """Closest hit + (box_tests, tri_tests) per ray.

    Debug/diagnostic path replicating the reference's stats counters
    (raytrace.comp:276): always uses the gather walk (the walk kernel
    keeps no counters).  Flattened scenes only need one
    walk; forest scenes scan objects like :func:`traverse`.  Sphere hits
    merge like :func:`traverse` (so full-path heatmaps follow the exact
    production paths) but are not counted — the reference's sphere loop
    increments nothing (raytrace.comp:282-287).
    """
    n = origin.shape[0]
    best = Hit(
        dst=jnp.full((n,), BIG) if tmax is None else jnp.asarray(tmax),
        kind=jnp.zeros((n,), jnp.int32),
        prim=jnp.zeros((n,), jnp.int32),
        obj=jnp.zeros((n,), jnp.int32),
        u=jnp.zeros((n,)),
        v=jnp.zeros((n,)),
        front=jnp.zeros((n,), bool),
    )
    if scene.n_spheres > 0:
        s_dst, s_front, s_hit = intersect.intersect_spheres(
            origin, direction, scene.sphere_pos, scene.sphere_radius
        )
        s_dst = jnp.where(s_hit, s_dst, BIG)
        si = jnp.argmin(s_dst, axis=1)
        sd = jnp.take_along_axis(s_dst, si[:, None], axis=1)[:, 0]
        sf = jnp.take_along_axis(s_front, si[:, None], axis=1)[:, 0]
        better = active & (sd < best.dst)
        best = Hit(
            dst=jnp.where(better, sd, best.dst),
            kind=jnp.where(better, KIND_SPHERE, best.kind),
            prim=jnp.where(better, si.astype(jnp.int32), best.prim),
            obj=best.obj,
            u=best.u,
            v=best.v,
            front=jnp.where(better, sf, best.front),
        )
    stats = (jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32))
    if scene.n_objects == 0 or scene.meta.get("n_tris", 0) == 0:
        return best, stats
    hit_links = scene.bvh_hit_link.reshape(-1)
    miss_links = scene.bvh_miss_link.reshape(-1)
    if scene.meta.get("flattened", False):
        return _walk(
            scene, hit_links, miss_links, origin, direction, active, best,
            root=scene.obj_bvh_root[0], obj_id=None, stats=stats,
        )

    def per_object(carry, obj_params):
        best, stats = carry
        inv_m, root, obj_id = obj_params
        inv_b = jnp.broadcast_to(inv_m, (n, 4, 4))
        o = _transform_point(inv_b, origin)
        d = _transform_dir(inv_b, direction)
        best, stats = _walk(
            scene, hit_links, miss_links, o, d, active, best,
            root=root, obj_id=obj_id, stats=stats,
        )
        return (best, stats), None

    obj_ids = jnp.arange(scene.obj_bvh_root.shape[0], dtype=jnp.int32)
    (best, stats), _ = jax.lax.scan(
        per_object,
        (best, stats),
        (scene.obj_inv_transform, scene.obj_bvh_root, obj_ids),
    )
    return best, stats


def _walk(scene, hit_links, miss_links, o, d, active, best, root, obj_id,
          stats=None, max_steps=None):
    """One stackless octant-threaded walk of a single BVH tree.

    ``obj_id=None``: flattened scene — the owning instance comes from the
    packed triangle row; otherwise the scalar instance id of this forest
    entry.  All hot-loop reads go through the *packed* single-row-per-record
    arrays (one gather per node, one per link pair, one per leaf triangle)
    instead of 8+ separate SoA gathers.

    ``stats``: optional (box_tests, tri_tests) counters, the analogue of the
    reference's ``stats[2]`` debug counters (raytrace.comp:276,310,338);
    updated per ray and returned alongside the hit when given.
    """
    n = o.shape[0]
    n_nodes = scene.bvh_index.shape[0]
    if max_steps is None:
        # each node is visited at most once per rope walk, so this bound
        # can never truncate a legitimate walk (a fixed bound would
        # silently drop hits on large trees)
        max_steps = n_nodes + 1
    max_leaf = scene.max_leaf_tris
    inv_dir = 1.0 / d
    octant = (
        (inv_dir[:, 0] < 0).astype(jnp.int32)
        + 2 * (inv_dir[:, 1] < 0).astype(jnp.int32)
        + 4 * (inv_dir[:, 2] < 0).astype(jnp.int32)
    )
    link_base = octant * n_nodes

    node0 = jnp.where(active, jnp.broadcast_to(root, (n,)).astype(jnp.int32), SENTINEL)

    with_stats = stats is not None
    if not with_stats:
        stats = (jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32))

    def cond(state):
        node, _, _, steps = state
        # the step bound turns a corrupted/cyclic link table (e.g. from a
        # bad native-builder build) into a truncated walk instead of a hang
        return jnp.any(node != SENTINEL) & (steps < max_steps)

    def body(state):
        node, best, (box_cnt, tri_cnt), steps = state
        live = node != SENTINEL
        ni = jnp.where(live, node, 0)
        row = scene.bvh_packed[ni]  # (N,8): min3|max3|idx|cnt
        idx = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
        cnt = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
        t_box = intersect.slab_test(o, inv_dir, row[:, 0:3], row[:, 3:6])
        box_hit = live & (t_box < best.dst)
        is_leaf = cnt > 0
        box_cnt = box_cnt + live.astype(jnp.float32)

        # Leaf: unrolled masked triangle tests (leaves are bounded by the
        # builder's max_leaf_tris).
        for k in range(max_leaf):
            valid = box_hit & is_leaf & (k < cnt)
            ti = jnp.where(valid, idx + k, 0)
            trow = scene.tri_packed[ti]  # (N,16)
            dst, u, v, w, front, hit = intersect.intersect_tris(
                o,
                d,
                trow[:, 0:3],
                trow[:, 3:6],
                trow[:, 6:9],
                trow[:, 9:12],
                trow[:, 12] > 0.5,
            )
            closer = valid & hit & (dst < best.dst)
            tri_cnt = tri_cnt + valid.astype(jnp.float32)
            owner = (
                jax.lax.bitcast_convert_type(trow[:, 13], jnp.int32)
                if obj_id is None
                else obj_id
            )
            best = Hit(
                dst=jnp.where(closer, dst, best.dst),
                kind=jnp.where(closer, KIND_TRI, best.kind),
                prim=jnp.where(closer, ti, best.prim),
                obj=jnp.where(closer, owner, best.obj),
                u=jnp.where(closer, u, best.u),
                v=jnp.where(closer, v, best.v),
                front=jnp.where(closer, front, best.front),
            )

        lrow = scene.links_packed[link_base + ni]  # (N,2): hit|miss
        go_deeper = box_hit & ~is_leaf
        nxt = jnp.where(go_deeper, lrow[:, 0], lrow[:, 1])
        node = jnp.where(live, nxt, SENTINEL)
        return node, best, (box_cnt, tri_cnt), steps + 1

    _, best, stats, _ = jax.lax.while_loop(
        cond, body, (node0, best, stats, jnp.int32(0))
    )
    if with_stats:
        return best, stats
    return best
