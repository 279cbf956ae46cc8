"""Binned-SAH BVH builder (vectorized numpy) + octant-threaded links.

Re-implements the reference builder's semantics (``src/vk_engine.cpp:
1169-1337``): per-mesh-group flat BVH forest, binned SAH with ``BINS=20``,
leaf termination at ``triCount <= 2`` or ``depth >= 64`` or when the best
split costs more than not splitting, with contiguous child pairs and an
in-place triangle partition.  Differences (deliberate, perf/correctness only
— node *semantics* and leaf coverage are identical):

* The reference's suffix-area scan has an indexing bug that overwrites half
  of ``rightArea`` with wrong values (``vk_engine.cpp:1313-1323``); we compute
  the correct suffix areas.  BVH shape only affects speed, not images.
* When SAH declines to split a node larger than ``max_leaf_tris``, we fall
  back to a median split so leaves stay small enough for the traversal
  loops to unroll (the reference lets leaves grow unboundedly).
* We additionally store the split axis per interior node and build eight
  *octant-threaded* link tables (hit/miss "ropes"), one per ray-direction
  sign combination, so device traversal is stackless: each ray carries a
  single node pointer instead of the reference's 64-deep local stack
  (``shaders/raytrace.comp:302-305``), so a ray's whole walk state is one
  integer plus its best hit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

BINS = 20  # reference vk_engine.h:203
MAX_DEPTH = 64  # reference vk_engine.cpp:1215
SAH_LEAF_TRIS = 2  # reference vk_engine.cpp:1215
SENTINEL = np.int32(2**31 - 1)


@dataclass
class BVHForest:
    """Flat SoA node arrays shared by every mesh group (one tree per group)."""

    node_min: np.ndarray  # (B,3) f32
    node_max: np.ndarray  # (B,3) f32
    index: np.ndarray  # (B,) i32: first child (interior) or first tri (leaf)
    tri_count: np.ndarray  # (B,) i32: 0 => interior
    axis: np.ndarray  # (B,) i8: split axis of interior nodes
    hit_link: np.ndarray  # (8,B) i32
    miss_link: np.ndarray  # (8,B) i32
    roots: List[int] = field(default_factory=list)
    max_leaf_tris: int = 0
    max_depth_seen: int = 0

    @property
    def n_nodes(self) -> int:
        return self.index.shape[0]


class _Builder:
    def __init__(self, tri_verts: np.ndarray, max_leaf_tris: int):
        self.verts = tri_verts.astype(np.float32)  # (T,3,3)
        self.tri_min = self.verts.min(axis=1)  # (T,3)
        self.tri_max = self.verts.max(axis=1)
        self.centroid = self.verts.sum(axis=1) / 3.0  # vk_engine.cpp:950-959
        self.perm = np.arange(tri_verts.shape[0], dtype=np.int64)
        self.max_leaf = max(int(max_leaf_tris), SAH_LEAF_TRIS)

        self.node_min: List[np.ndarray] = []
        self.node_max: List[np.ndarray] = []
        self.index: List[int] = []
        self.tri_count: List[int] = []
        self.axis: List[int] = []
        self.stats_max_leaf = 0
        self.stats_max_depth = 0

    # -- node helpers -----------------------------------------------------
    def _alloc(self, n: int) -> int:
        base = len(self.index)
        for _ in range(n):
            self.node_min.append(np.zeros(3, np.float32))
            self.node_max.append(np.zeros(3, np.float32))
            self.index.append(0)
            self.tri_count.append(0)
            self.axis.append(0)
        return base

    def _set_bounds(self, node: int, lo: int, hi: int) -> None:
        self.node_min[node] = self.tri_min[lo:hi].min(axis=0)
        self.node_max[node] = self.tri_max[lo:hi].max(axis=0)

    # -- SAH --------------------------------------------------------------
    def _find_split(self, lo: int, hi: int) -> Tuple[float, int, float]:
        """Best (cost, axis, splitPos) over 3 axes x (BINS-1) planes.

        Vectorized equivalent of ``find_bvh_split_plane``
        (``vk_engine.cpp:1279-1337``) with corrected suffix areas.
        """
        c = self.centroid[lo:hi]  # (n,3)
        tmin = self.tri_min[lo:hi]
        tmax = self.tri_max[lo:hi]
        best = (np.inf, -1, 0.0)
        for a in range(3):
            cmin = c[:, a].min()
            cmax = c[:, a].max()
            if cmin == cmax:
                continue
            scale = BINS / (cmax - cmin)
            bin_idx = np.minimum(
                BINS - 1, np.floor((c[:, a] - cmin) * scale).astype(np.int64)
            )
            # Bin bounds + counts via scatter-min/max.
            bmin = np.full((BINS, 3), np.inf, np.float32)
            bmax = np.full((BINS, 3), -np.inf, np.float32)
            np.minimum.at(bmin, bin_idx, tmin)
            np.maximum.at(bmax, bin_idx, tmax)
            counts = np.bincount(bin_idx, minlength=BINS).astype(np.float64)

            # Prefix (left) and suffix (right) box areas.
            lmin = np.minimum.accumulate(bmin, axis=0)
            lmax = np.maximum.accumulate(bmax, axis=0)
            rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]

            def area(mn, mx):
                e = np.maximum(mx - mn, 0.0)
                e = np.where(np.isfinite(e), e, 0.0)
                return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

            left_area = area(lmin, lmax)[: BINS - 1]
            right_area = area(rmin, rmax)[1:]
            left_count = np.cumsum(counts)[: BINS - 1]
            right_count = (counts.sum() - np.cumsum(counts))[: BINS - 1]
            cost = left_count * left_area + right_count * right_area
            cost = np.where((left_count == 0) | (right_count == 0), np.inf, cost)
            i = int(np.argmin(cost))
            if cost[i] < best[0]:
                best = (float(cost[i]), a, float(cmin + (cmax - cmin) / BINS * (i + 1)))
        return best

    def _partition(self, lo: int, hi: int, axis: int, split: float) -> int:
        """Stable-ish partition: centroids < split to the left.

        The reference uses an unstable two-pointer swap
        (``vk_engine.cpp:1238-1251``); only the *set* of tris per side matters
        for rendering, so we use argpartition-by-mask which is vectorized.
        Returns the first index of the right side.
        """
        mask = self.centroid[lo:hi, axis] < split
        order = np.concatenate([np.nonzero(mask)[0], np.nonzero(~mask)[0]]) + lo
        self._apply_order(lo, hi, order)
        return lo + int(mask.sum())

    def _median_split(self, lo: int, hi: int) -> Tuple[int, int]:
        """Fallback when SAH refuses: split at median of the widest axis."""
        c = self.centroid[lo:hi]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable") + lo
        self._apply_order(lo, hi, order)
        return lo + (hi - lo) // 2, axis

    def _apply_order(self, lo: int, hi: int, order: np.ndarray) -> None:
        for arr in (self.tri_min, self.tri_max, self.centroid, self.verts):
            arr[lo:hi] = arr[order]
        self.perm[lo:hi] = self.perm[order]

    # -- recursion --------------------------------------------------------
    def build_group(self, lo: int, hi: int) -> int:
        root = self._alloc(1)
        self.index[root] = lo
        self.tri_count[root] = hi - lo
        self._set_bounds(root, lo, hi)
        # Iterative DFS (explicit stack) to dodge Python recursion limits.
        stack = [(root, lo, hi, 0)]
        while stack:
            node, nlo, nhi, depth = stack.pop()
            n = nhi - nlo
            self.stats_max_depth = max(self.stats_max_depth, depth)
            if n <= self.max_leaf or depth >= MAX_DEPTH:
                self.stats_max_leaf = max(self.stats_max_leaf, n)
                continue
            cost, axis, split = self._find_split(nlo, nhi)
            ext = self.node_max[node] - self.node_min[node]
            parent_area = float(
                ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0]
            )
            no_split_cost = n * parent_area  # vk_engine.cpp:1229
            mid = -1
            if axis >= 0 and cost < no_split_cost:
                mid = self._partition(nlo, nhi, axis, split)
                if mid == nlo or mid == nhi:
                    mid = -1
            if mid < 0:
                if n > self.max_leaf:
                    mid, axis = self._median_split(nlo, nhi)
                else:
                    self.stats_max_leaf = max(self.stats_max_leaf, n)
                    continue
            child = self._alloc(2)
            self.index[child] = nlo
            self.tri_count[child] = mid - nlo
            self.index[child + 1] = mid
            self.tri_count[child + 1] = nhi - mid
            self._set_bounds(child, nlo, mid)
            self._set_bounds(child + 1, mid, nhi)
            self.index[node] = child
            self.tri_count[node] = 0
            self.axis[node] = axis
            stack.append((child + 1, mid, nhi, depth + 1))
            stack.append((child, nlo, mid, depth + 1))
        return root


def _thread_links(
    index: np.ndarray,
    tri_count: np.ndarray,
    axis: np.ndarray,
    roots: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the 8 octant-ordered hit/miss link tables.

    For octant ``o`` (bit ``a`` set <=> ray direction negative along axis
    ``a``), the near child of an interior node split on axis ``a`` is the
    *left* child when the direction is positive (left holds centroids below
    the split plane, ``vk_engine.cpp:1244``), else the right child.
    Traversal: AABB hit & interior -> ``hit_link`` (near child); AABB miss,
    or leaf after intersecting its tris -> ``miss_link``.
    """
    n = index.shape[0]
    hit = np.full((8, n), SENTINEL, np.int32)
    miss = np.full((8, n), SENTINEL, np.int32)
    interior = tri_count == 0
    for o in range(8):
        neg = np.array([(o >> a) & 1 for a in range(3)], bool)
        for root in roots:
            # stack of (node, after)
            stack = [(int(root), int(SENTINEL))]
            while stack:
                node, after = stack.pop()
                miss[o, node] = after
                if interior[node]:
                    left = int(index[node])
                    right = left + 1
                    near, far = (
                        (right, left) if neg[axis[node]] else (left, right)
                    )
                    hit[o, node] = near
                    stack.append((near, far))
                    stack.append((far, after))
                else:
                    hit[o, node] = after
    return hit, miss


def build_forest(
    tri_verts: np.ndarray,
    groups: Sequence[Tuple[int, int]],
    max_leaf_tris: int = 4,
    use_native: bool = True,
    spatial: bool = False,
) -> Tuple[BVHForest, np.ndarray]:
    """Build one BVH per (offset, count) triangle group.

    Returns the forest and the permutation mapping new (reordered) triangle
    slots to original triangle indices — apply it once to every per-triangle
    attribute array.  With ``spatial=True`` (single-group scenes only) the
    native SBVH builder runs instead: spatial splits duplicate triangle
    *references*, so the permutation may be LONGER than the input (fancy
    indexing with it duplicates attribute rows — exactly what leaves need).

    Dispatches to the C++ builder (accel/native.py) when available — numpy
    SAH takes minutes on Sponza-class meshes; set use_native=False (or env
    RT_NATIVE_BVH=0) to force the pure-numpy path.
    """
    import os as _os

    native_ok = (
        use_native
        and tri_verts.shape[0] > 1
        and _os.environ.get("RT_NATIVE_BVH", "1") != "0"
    )
    if spatial and len(groups) == 1 and native_ok:
        from . import native

        out = native.build_sbvh_native(tri_verts, max_leaf_tris)
        if out is not None:
            return out
    if native_ok:
        from . import native

        out = native.build_forest_native(tri_verts, groups, max_leaf_tris)
        if out is not None:
            # callers apply the returned perm to their attribute arrays
            return out
    return _build_forest_numpy(tri_verts, groups, max_leaf_tris)


def _build_forest_numpy(
    tri_verts: np.ndarray,
    groups: Sequence[Tuple[int, int]],
    max_leaf_tris: int = 4,
) -> Tuple[BVHForest, np.ndarray]:
    b = _Builder(tri_verts, max_leaf_tris)
    roots = [b.build_group(lo, lo + n) for lo, n in groups]
    index = np.asarray(b.index, np.int32)
    tri_count = np.asarray(b.tri_count, np.int32)
    axis = np.asarray(b.axis, np.int8)
    hit, miss = _thread_links(index, tri_count, axis, roots)
    forest = BVHForest(
        node_min=np.stack(b.node_min) if b.node_min else np.zeros((0, 3), np.float32),
        node_max=np.stack(b.node_max) if b.node_max else np.zeros((0, 3), np.float32),
        index=index,
        tri_count=tri_count,
        axis=axis,
        hit_link=hit,
        miss_link=miss,
        roots=[int(r) for r in roots],
        max_leaf_tris=int(max(b.stats_max_leaf, 1)),
        max_depth_seen=int(b.stats_max_depth),
    )
    return forest, b.perm
