"""ctypes loader for the C++ OBJ tokenizer (``obj_parser.cpp``, a copy of
the reference's ``ray_tracer_2_tpu/assets/native``; ref: the tobj crate,
asset.rs:110-118).

Compiled with g++ at first use (``host_build.build_library``, as the BVH
builder is). As in the reference, a failed build or load is not an error:
``get_lib`` returns None and ``assets/obj.py`` tokenizes in Python instead.
"""
from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path

import numpy as np

from ray_tracer_2_tpu_torch.host_build import build_library

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "obj_parser.cpp"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_tried = False


def get_lib():
    """The loaded library, or None if it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_library(_SRC, "obj_parser", _FLAGS)))
        except (OSError, RuntimeError) as e:
            log.warning("native OBJ parser unavailable (%s); using python", e)
            return None
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p]
        for name in ("obj_nv", "obj_nt", "obj_nn", "obj_ntris"):
            getattr(lib, name).restype = ctypes.c_longlong
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("obj_ok", "obj_ngroups"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("obj_v", "obj_vt", "obj_vn"):
            getattr(lib, name).restype = ctypes.POINTER(ctypes.c_float)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.obj_tris.restype = ctypes.POINTER(ctypes.c_longlong)
        lib.obj_tris.argtypes = [ctypes.c_void_p]
        lib.obj_tri_group.restype = ctypes.POINTER(ctypes.c_int)
        lib.obj_tri_group.argtypes = [ctypes.c_void_p]
        for name in ("obj_groups", "obj_mtllibs"):
            getattr(lib, name).restype = ctypes.c_char_p
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.obj_free.restype = None
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def parse_obj_native(path):
    """Parse with the C++ tokenizer. Returns the same intermediate structure
    as the Python parse phase — (positions, uvs, normals,
    ordered {(obj_name, mtl_name|None): (T, 3, 3) int64 index array},
    [mtllib names]) — or None if the native path is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.obj_parse(str(path).encode())
    try:
        if not lib.obj_ok(h):
            return None
        nv, nt, nn = lib.obj_nv(h), lib.obj_nt(h), lib.obj_nn(h)
        ntris = lib.obj_ntris(h)

        def arr(ptr, n, dtype):
            if n == 0:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype,
                                                                 copy=True)

        pos = arr(lib.obj_v(h), nv * 3, np.float32).reshape(-1, 3)
        uv = arr(lib.obj_vt(h), nt * 2, np.float32).reshape(-1, 2)
        nrm = arr(lib.obj_vn(h), nn * 3, np.float32).reshape(-1, 3)
        tris = arr(lib.obj_tris(h), ntris * 9, np.int64).reshape(-1, 3, 3)
        gid = arr(lib.obj_tri_group(h), ntris, np.int64)

        blob = lib.obj_groups(h).decode(errors="replace")
        keys = []
        for entry in blob.split("\x1e")[:-1] if blob else []:
            name, mtl = entry.split("\x1f", 1)
            keys.append((name, None if mtl == "\x1b" else mtl))

        groups = {}
        for g, key in enumerate(keys):
            sel = tris[gid == g]
            if len(sel):
                groups[key] = sel
        mtllibs = [m for m in
                   lib.obj_mtllibs(h).decode(errors="replace").split("\n")
                   if m]
        return pos, uv, nrm, groups, mtllibs
    finally:
        lib.obj_free(h)
