"""Build and load of the port's CUDA kernels (``csrc/*.cu``).

Each kernel source has a plain C entry point. At first use it is compiled
with ``nvcc`` for Hopper (sm_90a) into a shared library under
``ray_tracer_2_tpu_torch/_build/``, named by a hash of the source, the
headers it includes and the flags, so a changed source or header is
rebuilt, and loaded with ``ctypes``. The wrappers
(``kernels/megakernel.py``, ``kernels/spheres.py``, ``kernels/brute.py``)
subclass ``CudaKernel`` with their symbol, argument types and launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC"]
#: int64 words of the per-launch scratch of the persistent kernels
#: (csrc/claim.cuh kScratchWords): the exact segment count, the pixel
#: cursor (the low 32 bits of its word) and a flag the launch sets once
LAUNCH_SCRATCH = 3


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError("nvcc not found: the CUDA kernel is built on a "
                            "machine with the CUDA toolkit")


def source_bytes(path: Path) -> bytes:
    """The source followed by every header it includes by a quoted path
    (``#include "x.cuh"``, resolved beside it), recursively: what the build
    hash covers, so an edit to a shared header rebuilds every kernel that
    includes it."""
    src = Path(path).read_bytes()
    parts = [src]
    for m in re.finditer(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', src,
                         re.M):
        parts.append(source_bytes(Path(path).parent / m.group(1).decode()))
    return b"".join(parts)


class CudaKernel:
    """One ``csrc`` source and its C entry point ``symbol``: builds the
    library at first use (rebuilding when the source or flags change),
    loads it, and keeps the count of launches in ``launches`` (the
    subclass's ``__call__`` adds one per launch) and the kernel's own
    device counts named in ``counts`` (int64 words the kernel adds to,
    per device, in the C source's order). ``reset_counts`` zeroes both."""

    symbol: str = ""
    argtypes: list = []
    counts: tuple = ()

    def __init__(self, source: Path, build_dir: Path = BUILD_DIR):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.launches = 0
        self.build_seconds = 0.0   # nvcc time of this process's build
        self.build_log = ""        # nvcc/ptxas output (registers, spills)
        self._fn = None
        self._lock = threading.Lock()
        self._counts = {}          # device -> int64 words of ``counts``

    def build(self):
        """Compile (if the library for this source is missing) and load;
        returns the C entry point."""
        with self._lock:
            if self._fn is None:
                self._fn = self._load()
            return self._fn

    def _load(self):
        src = source_bytes(self.source)
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
            .hexdigest()[:16]
        lib = self.build_dir / f"{self.source.stem}_{tag}.so"
        if not lib.exists():
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                  str(self.source)],
                                 capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({res.returncode}):\n{self.build_log}")
            os.replace(tmp, lib)
        fn = getattr(ctypes.CDLL(str(lib)), self.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(self.argtypes)
        return fn

    def device_counts(self, dev: torch.device) -> torch.Tensor:
        """The int64 words on ``dev`` that the kernel adds its counts to
        (zeroed at first use)."""
        c = self._counts.get(dev)
        if c is None:
            c = self._counts[dev] = torch.zeros(
                len(self.counts), dtype=torch.int64, device=dev)
        return c

    def read_counts(self) -> dict:
        """What the kernel counted on the device since the last
        ``reset_counts``, summed over devices. Synchronises."""
        total = [0] * len(self.counts)
        for c in self._counts.values():
            total = [a + b for a, b in zip(total, c.tolist())]
        return dict(zip(self.counts, total))

    def reset_counts(self) -> None:
        """Set the launch count and the kernel's device counts to 0."""
        self.launches = 0
        for c in self._counts.values():
            c.zero_()


def check_launch(dev, *, width: int, height: int, row_start: int,
                 rows: int, **tables) -> None:
    """Raise ``ValueError`` unless the image window lies in the image and
    every table is a contiguous float32 tensor on ``dev``; a table given as
    ``(tensor, cols)`` must also be 2-D with ``cols`` columns."""
    if rows <= 0 or width <= 0 or row_start < 0 or row_start + rows > height:
        raise ValueError(f"bad image window: rows {rows} from {row_start} "
                         f"of {height}, width {width}")
    for name, (x, cols) in tables.items():
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous() \
                or (cols is not None and (x.dim() != 2
                                          or x.shape[1] != cols)):
            raise ValueError(f"{name}: expected contiguous float32 "
                             f"(n, {cols}) on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def launch_scratch(dev: torch.device) -> torch.Tensor:
    """The zeroed per-launch scratch of a persistent kernel on ``dev``:
    ``LAUNCH_SCRATCH`` int64 words, word 0 the segment count."""
    return torch.zeros(LAUNCH_SCRATCH, dtype=torch.int64, device=dev)


def check_aligned(name: str, x: torch.Tensor, nbytes: int) -> None:
    """Raise ``ValueError`` unless ``x``'s data starts on an
    ``nbytes``-byte boundary (a kernel reads it in ``nbytes``-byte
    loads)."""
    if x.data_ptr() % nbytes:
        raise ValueError(f"{name}: data must start on a {nbytes}-byte "
                         f"boundary (a view at an offset? pass a copy)")


def frame_seed(frames: int) -> int:
    """The per-frame term of the pixel seed, ``|frames| * 719393`` mod 2^32
    (ray_tracer.wgsl:475), as the kernels take it."""
    return ((abs(int(frames)) & 0xFFFFFFFF) * 719393) & 0xFFFFFFFF


def build_all(*kernels: CudaKernel) -> None:
    """Build the kernels' libraries side by side (one nvcc each)."""
    with ThreadPoolExecutor(max_workers=max(len(kernels), 1)) as pool:
        for f in [pool.submit(k.build) for k in kernels]:
            f.result()
