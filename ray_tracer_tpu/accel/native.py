"""ctypes bridge to the native C++ BVH builder.

Compiles ``csrc/bvh_builder.cpp`` on first use (g++ -O3 -shared) into
``build/native/`` of the checkout (``RT_CACHE`` overrides), keyed by
source hash.  Falls back silently to the numpy
builder when no toolchain is available (``available()`` returns False).
Semantics match accel/bvh.py; the in-leaf triangle *order* may differ (the
C++ uses the reference's unstable two-pointer partition,
``vk_engine.cpp:1240-1251``), which changes nothing observable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "bvh_builder.cpp")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cache_dir() -> str:
    from ..utils.cache import NATIVE_DIR

    d = os.environ.get("RT_CACHE", NATIVE_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so_path = os.path.join(_cache_dir(), f"bvh_builder_{tag}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.rt_build_bvh.restype = ctypes.c_int64
        lib.rt_build_sbvh.restype = ctypes.c_int64
        lib.rt_build_sbvh.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def build_sbvh_native(
    tri_verts: np.ndarray,
    max_leaf_tris: int = 4,
    alpha: float = 1e-5,
    budget_factor: float = 1.5,
):
    """Spatial-split BVH (SBVH) over ONE triangle group.

    Returns ``(forest, perm)`` where ``perm`` has ``n_refs >= n_tris``
    entries mapping reference slots to ORIGINAL triangle ids — apply it to
    per-triangle attribute arrays exactly like the plain builder's
    permutation (duplicated rows are the cost of spatial splits).  Returns
    None if the native library is unavailable (there is no numpy twin; the
    pure-numpy pipeline builds the plain SAH tree instead).

    ``alpha``: object-split child-overlap fraction of the root area above
    which a spatial split is considered (Stich et al. 2009's lambda).
    ``budget_factor``: cap on total references as a multiple of n_tris.
    """
    lib = _load()
    if lib is None:
        return None
    from .bvh import BVHForest

    t = np.ascontiguousarray(tri_verts.reshape(-1, 9), np.float32)
    n_tris = t.shape[0]
    budget = int(budget_factor * n_tris) + 16
    max_nodes = 2 * budget
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    index = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    axis = np.empty(max_nodes, np.int8)
    hit = np.empty(8 * max_nodes, np.int32)
    miss = np.empty(8 * max_nodes, np.int32)
    perm = np.empty(budget, np.int64)
    stats = np.zeros(3, np.int32)

    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    n_nodes = lib.rt_build_sbvh(
        c(t), n_tris, max_leaf_tris, float(alpha), float(budget_factor),
        c(node_min), c(node_max), c(index), c(count), c(axis),
        c(hit), c(miss), c(perm), c(stats),
    )
    if n_nodes <= 0:
        return None
    n_refs = int(stats[2])
    hit = hit[: 8 * n_nodes].reshape(8, n_nodes).copy()
    miss = miss[: 8 * n_nodes].reshape(8, n_nodes).copy()
    forest = BVHForest(
        node_min=node_min[:n_nodes].copy(),
        node_max=node_max[:n_nodes].copy(),
        index=index[:n_nodes].copy(),
        tri_count=count[:n_nodes].copy(),
        axis=axis[:n_nodes].copy(),
        hit_link=hit,
        miss_link=miss,
        roots=[0],
        max_leaf_tris=int(max(stats[0], 1)),
        max_depth_seen=int(stats[1]),
    )
    return forest, perm[:n_refs].copy()


def build_forest_native(
    tri_verts: np.ndarray, groups: Sequence[Tuple[int, int]], max_leaf_tris: int = 4
):
    """Same contract as accel.bvh.build_forest, via the C++ builder.

    Returns None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    from .bvh import BVHForest

    t = np.ascontiguousarray(tri_verts.reshape(-1, 9), np.float32)
    n_tris = t.shape[0]
    offsets = []
    pos = None
    # groups must be contiguous ascending (they are, by construction)
    offs = [groups[0][0]]
    for lo, cnt in groups:
        assert lo == offs[-1], "groups must be contiguous"
        offs.append(lo + cnt)
    offsets = np.asarray(offs, np.int64)

    max_nodes = 2 * max(n_tris, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    index = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    axis = np.empty(max_nodes, np.int8)
    hit = np.empty(8 * max_nodes, np.int32)
    miss = np.empty(8 * max_nodes, np.int32)
    perm = np.empty(n_tris, np.int64)
    roots = np.empty(len(groups), np.int32)
    stats = np.zeros(2, np.int32)

    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    n_nodes = lib.rt_build_bvh(
        c(t),
        ctypes.c_int64(n_tris),
        c(offsets),
        ctypes.c_int64(len(groups)),
        ctypes.c_int32(max_leaf_tris),
        c(node_min),
        c(node_max),
        c(index),
        c(count),
        c(axis),
        c(hit),
        c(miss),
        c(perm),
        c(roots),
        c(stats),
    )
    if n_nodes <= 0:
        return None
    # links were written with row stride == actual node count
    hit = hit[: 8 * n_nodes].reshape(8, n_nodes).copy()
    miss = miss[: 8 * n_nodes].reshape(8, n_nodes).copy()
    forest = BVHForest(
        node_min=node_min[:n_nodes].copy(),
        node_max=node_max[:n_nodes].copy(),
        index=index[:n_nodes].copy(),
        tri_count=count[:n_nodes].copy(),
        axis=axis[:n_nodes].copy(),
        hit_link=hit,
        miss_link=miss,
        roots=[int(r) for r in roots],
        max_leaf_tris=int(max(stats[0], 1)),
        max_depth_seen=int(stats[1]),
    )
    return forest, perm
