"""Per-ray BVH walk as one Pallas kernel on the Triton route (GPU).

The same stackless octant-threaded rope walk as the XLA gather walk
(:func:`ray_tracer_tpu.ops.traverse._walk`) over the same packed tables
(``bvh_packed``, ``tri_packed``, ``links_packed``), but fused: one program
owns a block of ``BLOCK`` rays, one ray per GPU thread, and each lane keeps
its node pointer and best ``(dst, prim)`` in registers through an in-kernel
``lax.while_loop`` until every lane of the block reaches the sentinel.  The
XLA walk instead runs each loop step as several kernel launches that
rewrite all per-lane state in device memory and copy the loop predicate to
the host.

Per step each live lane gathers its node row and runs the slab test; on a
leaf it tests up to ``max_leaf`` triangle rows (masked loads, so lanes
elsewhere issue no memory traffic) with the Moller-Trumbore arithmetic of
:func:`ray_tracer_tpu.ops.intersect.intersect_tris`; then it gathers its
link pair.  ``anyhit=True`` ends a lane at its first accepted hit inside
``tmax`` (occlusion queries).

``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..ops.intersect import BIG, EPS_FRONT

SENTINEL = np.int32(2**31 - 1)

# Rays per program: one ray per thread of a 4-warp block.
BLOCK = 128
NUM_WARPS = 4

# Row layout of the (8, N) ray array the wrapper builds.
_OX, _OY, _OZ, _TMAX, _DX, _DY, _DZ = range(7)


def _walk_kernel(rays_ref, bvh_ref, tri_ref, link_ref, dst_ref, prim_ref, *,
                 n_nodes, root, max_leaf, max_steps, anyhit):
    o = [rays_ref[k, :] for k in (_OX, _OY, _OZ)]
    d = [rays_ref[k, :] for k in (_DX, _DY, _DZ)]
    tmax = rays_ref[_TMAX, :]
    inv = [1.0 / c for c in d]
    octant = (
        (inv[0] < 0).astype(jnp.int32)
        + 2 * (inv[1] < 0).astype(jnp.int32)
        + 4 * (inv[2] < 0).astype(jnp.int32)
    )
    link_base = octant * n_nodes
    # inactive lanes come in with tmax = -BIG and never leave the sentinel
    node0 = jnp.where(tmax > -1.0, jnp.int32(root), SENTINEL)
    prim0 = jnp.full(tmax.shape, -1, jnp.int32)

    def cond(state):
        node, _, _, steps = state
        live = jnp.max((node != SENTINEL).astype(jnp.int32))
        return (live > 0) & (steps < max_steps)

    def body(state):
        node, best, prim, steps = state
        live = node != SENTINEL
        ni = jnp.where(live, node, 0)
        row = [plgpu.load(bvh_ref.at[ni, k]) for k in range(8)]
        idx = jax.lax.bitcast_convert_type(row[6], jnp.int32)
        cnt = jax.lax.bitcast_convert_type(row[7], jnp.int32)

        # slab test (intersect.slab_test)
        t1, t2 = [], []
        for a in range(3):
            lo = (row[a] - o[a]) * inv[a]
            hi = (row[3 + a] - o[a]) * inv[a]
            t1.append(jnp.minimum(lo, hi))
            t2.append(jnp.maximum(lo, hi))
        t_near = jnp.maximum(jnp.maximum(t1[0], t1[1]), t1[2])
        t_far = jnp.minimum(jnp.minimum(t2[0], t2[1]), t2[2])
        box = (t_far >= t_near) & (t_far > 0)
        t_box = jnp.where(box, jnp.maximum(t_near, 0.0), BIG)
        box_hit = live & (t_box < best)
        is_leaf = cnt > 0

        for k in range(max_leaf):
            valid = box_hit & is_leaf & (k < cnt)
            ti = jnp.where(valid, idx + k, 0)
            t = [
                plgpu.load(tri_ref.at[ti, c], mask=valid, other=0.0)
                for c in range(13)
            ]
            v0, e1, e2, nrm = t[0:3], t[3:6], t[6:9], t[9:12]
            # Moller-Trumbore (intersect.intersect_tris)
            r = [o[a] - v0[a] for a in range(3)]
            q = [
                r[1] * d[2] - r[2] * d[1],
                r[2] * d[0] - r[0] * d[2],
                r[0] * d[1] - r[1] * d[0],
            ]
            d0 = -(d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2])
            dd = 1.0 / d0
            dst = (r[0] * nrm[0] + r[1] * nrm[1] + r[2] * nrm[2]) * dd
            u = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * dd
            v = -(e1[0] * q[0] + e1[1] * q[1] + e1[2] * q[2]) * dd
            w = 1.0 - u - v
            front = d0 >= EPS_FRONT
            culled = ~front & (t[12] > 0.5)
            hit = (dst >= 0) & (u >= 0) & (v >= 0) & (w >= 0) & ~culled
            closer = valid & hit & (dst < best)
            best = jnp.where(closer, dst, best)
            prim = jnp.where(closer, ti, prim)

        li = link_base + ni
        nxt = jnp.where(
            box_hit & ~is_leaf,
            plgpu.load(link_ref.at[li, 0]),
            plgpu.load(link_ref.at[li, 1]),
        )
        node = jnp.where(live, nxt, SENTINEL)
        if anyhit:
            node = jnp.where(prim >= 0, SENTINEL, node)
        return node, best, prim, steps + 1

    _, best, prim, _ = jax.lax.while_loop(
        cond, body, (node0, tmax, prim0, jnp.int32(0))
    )
    dst_ref[:] = best
    prim_ref[:] = prim


@functools.partial(
    jax.jit,
    static_argnames=("root", "max_leaf", "anyhit", "interpret"),
)
def walk_traverse(bvh_packed, tri_packed, links_packed, origin, direction,
                  tmax0, *, root, max_leaf, anyhit=False, interpret=False):
    """Closest (or any) triangle hit per ray over one flattened BVH.

    ``tmax0`` (N,) is each lane's search radius; lanes with
    ``tmax0 <= -1`` are inactive.  Returns ``(dst, prim)``: ``prim`` is the
    global triangle id of the hit, -1 when the lane found none (``dst``
    then stays at ``tmax0``).  With ``anyhit`` the hit is the first one
    accepted inside ``tmax0``, not the closest.
    """
    n = origin.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    pad = n_pad - n
    rays = jnp.concatenate(
        [
            origin.T.astype(jnp.float32),
            tmax0[None].astype(jnp.float32),
            direction.T.astype(jnp.float32),
            jnp.zeros((1, n), jnp.float32),
        ]
    )
    if pad:
        fill = jnp.zeros((8, pad), jnp.float32).at[_TMAX].set(-BIG)
        fill = fill.at[_DX:_DZ + 1].set(1.0)
        rays = jnp.concatenate([rays, fill], axis=1)
    n_nodes = bvh_packed.shape[0]
    kernel = functools.partial(
        _walk_kernel,
        n_nodes=n_nodes,
        root=int(root),
        max_leaf=int(max_leaf),
        # each node is visited at most once per rope walk; the bound only
        # turns a corrupt (cyclic) link table into a truncated walk
        max_steps=n_nodes + 1,
        anyhit=bool(anyhit),
    )
    dst, prim = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        ),
        grid=(n_pad // BLOCK,),
        in_specs=[
            pl.BlockSpec((8, BLOCK), lambda i: (0, i)),
            pl.no_block_spec,
            pl.no_block_spec,
            pl.no_block_spec,
        ],
        out_specs=(
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
        ),
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="bvh_walk_anyhit" if anyhit else "bvh_walk",
    )(rays, bvh_packed, tri_packed, links_packed)
    return dst[:n], prim[:n]
