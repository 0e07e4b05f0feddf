"""ctypes loader for the C++ BVH builder (``bvh_builder.cpp``, a copy of the
reference's ``ray_tracer_2_tpu/accel/native``; ref: the rayon-parallel Rust
builder, bvh.rs:152-207).

Compiled with g++ at first use (``host_build.build_library``); a failed
compile raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ray_tracer_2_tpu_torch.host_build import build_library

_SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
          "-pthread"]
_lock = threading.Lock()
_lib = None


def get_lib():
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library(_SRC, "bvh_builder", _FLAGS)))
        lib.rt2_build_bvh.restype = ctypes.c_int32
        lib.rt2_build_bvh.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # v0 v1 v2
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,      # n, leaf, q
            ctypes.c_void_p, ctypes.c_void_p,                    # min max
            ctypes.c_void_p, ctypes.c_void_p,                    # left right
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # first count axis
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,     # order maxn par
        ]
        _lib = lib
        return _lib


def build_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                 max_leaf: int, quality: int):
    """Dict of node arrays + triangle order, or None if the node buffer
    overflowed (the caller then builds with numpy, as the reference does)."""
    lib = get_lib()
    n = len(v0)
    max_nodes = max(2 * n + 16, 64)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    left = np.empty(max_nodes, np.int32)
    right = np.empty(max_nodes, np.int32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    axis = np.empty(max_nodes, np.int32)
    order = np.empty(max(n, 1), np.int64)

    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)

    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    n_nodes = lib.rt2_build_bvh(
        ptr(v0), ptr(v1), ptr(v2), n, max_leaf, quality,
        ptr(node_min), ptr(node_max), ptr(left), ptr(right), ptr(first),
        ptr(count), ptr(axis), ptr(order), max_nodes, 1)
    if n_nodes < 0:
        return None
    s = slice(0, n_nodes)
    return dict(node_min=node_min[s], node_max=node_max[s], node_left=left[s],
                node_right=right[s], node_first=first[s],
                node_count=count[s], node_axis=axis[s],
                tri_order=order[:n])
