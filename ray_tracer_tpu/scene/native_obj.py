"""ctypes bridge to the native OBJ scanner (csrc/obj_scan.cpp).

Same first-use g++ compile-and-cache pattern as accel/native.py.  The
scanner replicates objio.parse_obj's semantics bit for bit (tested over
every reference asset, tests/test_scene.py); objio falls back to the
pure-Python parser when the toolchain is unavailable, the env says
RT_NATIVE_OBJ=0, or the scanner reports malformed input.

Why native: the reference's OBJ loader is host C++ and prints its load
time as a tracked stat (src/vk_engine.cpp:822,1036); the Python parser
runs ~100k tris/s, which puts a Sponza-class .obj at seconds of load
time — the scanner does the same work ~20x faster.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "obj_scan.cpp")
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
        so_path = os.path.join(_cache_dir(), f"obj_scan_{tag}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
                 "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.rt_obj_sizes.restype = ctypes.c_int64
        lib.rt_obj_sizes.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.rt_obj_parse.restype = ctypes.c_int64
        lib.rt_obj_parse.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 8
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def parse_obj_native(path: str):
    """Native twin of objio.parse_obj; returns an ObjMesh or None on any
    failure (caller falls back to the Python parser)."""
    lib = _load()
    if lib is None:
        return None
    from .objio import ObjGroup, ObjMesh

    pathb = os.fsencode(path)
    sizes = np.zeros(6, np.int64)
    if lib.rt_obj_sizes(pathb, sizes.ctypes.data_as(ctypes.c_void_p)) < 0:
        return None
    n_tris, n_groups, mat_bytes, mtllib_bytes = (int(x) for x in sizes[:4])
    tri_pos = np.empty((max(n_tris, 1), 3, 3), np.float32)
    tri_nrm = np.empty((max(n_tris, 1), 3, 3), np.float32)
    tri_uv = np.empty((max(n_tris, 1), 3, 2), np.float32)
    group_start = np.empty(n_groups + 1, np.int32)
    group_smooth = np.empty(max(n_groups, 1), np.uint8)
    group_mat_off = np.empty(max(n_groups, 1), np.int64)
    mat_buf = ctypes.create_string_buffer(max(mat_bytes, 1))
    mtllib_buf = ctypes.create_string_buffer(max(mtllib_bytes, 1))

    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    got = lib.rt_obj_parse(
        pathb, c(tri_pos), c(tri_nrm), c(tri_uv), c(group_start),
        c(group_smooth), c(group_mat_off), mat_buf, mtllib_buf,
    )
    if got < 0 or got != n_groups:
        return None

    mesh = ObjMesh()
    raw_mtl = mtllib_buf.value.decode("utf-8", errors="replace")
    if raw_mtl:
        mesh.mtl_path = os.path.join(os.path.dirname(path), raw_mtl)
    for g in range(n_groups):
        lo, hi = int(group_start[g]), int(group_start[g + 1])
        off = int(group_mat_off[g])
        mat = None
        if off >= 0:
            end = mat_buf.raw.index(b"\0", off)
            mat = mat_buf.raw[off:end].decode("utf-8", errors="replace")
        mesh.groups.append(
            ObjGroup(
                material=mat,
                smooth=bool(group_smooth[g]),
                positions=tri_pos[lo:hi].copy(),
                normals=tri_nrm[lo:hi].copy(),
                uvs=tri_uv[lo:hi].copy(),
            )
        )
    return mesh
