"""The debug modes' render (port of the reference's deterministic tiled
debug path, ``ray_tracer_2_tpu/engine/renderer.py:render_sample`` with
``debug_mode`` set, over ``kernels/trace.py:debug_trace_pixels``).

Two implementations of one function, chosen by the device the scene's
tensors live on, never by a switch:

* ``render_debug_plain`` — the plain PyTorch version
  (``kernels/trace.py:debug_hit`` and ``debug_colors``), in chunks of
  ``PLAIN_CHUNK`` pixels. It serves CPU tensors, and ``chip_smoke.py``
  holds the kernel against it on the card.
* ``CUDA_DEBUG`` — the hand-written CUDA kernel (``csrc/debug.cu``, over
  the megakernel's device code in ``csrc/trace.cuh``): one thread a pixel,
  one launch a frame. It serves CUDA tensors; there is no fallback.

Both return the colours and the per-ray counts of the heat-map modes
(child boxes tested, triangles tested; ``kernels/trace.py`` defines them).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ray_tracer_2_tpu_torch.kernels.brute import stage_brute_rows
from ray_tracer_2_tpu_torch.kernels.cuda_build import (
    PKG, CudaKernel, check_aligned, check_launch, check_window, launch_on,
)
from ray_tracer_2_tpu_torch.kernels.megakernel import (
    BRUTE_STAGED, INST_COLS, PLAIN_CHUNK, SPHERE_COLS, _brute_ranges,
    _require_eligible, kernel_tables,
)
from ray_tracer_2_tpu_torch.kernels.trace import debug_colors, debug_hit
from ray_tracer_2_tpu_torch.scene.render_scene import TorchScene


def render_debug(scene: TorchScene, *, width: int, height: int,
                 debug_mode: int, debug_scale: float, row_start: int = 0,
                 rows: int | None = None):
    """The image of debug mode ``debug_mode``, its ``rows`` image rows from
    ``row_start`` (``width``/``height`` describe the full image). Returns
    ((rows, width, 4) float32 colours, (rows, width, 2) int32 counts: child
    boxes tested, triangles tested) on the scene's device. CPU scenes take
    the plain version; CUDA scenes take the kernel."""
    kw = dict(width=width, height=height, debug_mode=debug_mode,
              debug_scale=debug_scale, row_start=row_start, rows=rows)
    if scene.device.type == "cpu":
        return render_debug_plain(scene, **kw)
    if scene.device.type == "cuda":
        return CUDA_DEBUG(scene, **kw)
    raise ValueError(f"no implementation for device {scene.device}")


def render_debug_plain(scene: TorchScene, *, width: int, height: int,
                       debug_mode: int, debug_scale: float,
                       row_start: int = 0, rows: int | None = None,
                       modes=None):
    """The plain PyTorch version of ``render_debug`` (any device). Given
    ``modes``, returns ({mode: colours} for each of them, counts) from one
    hit record instead."""
    rows = height if rows is None else rows
    check_window(width=width, height=height, row_start=row_start, rows=rows)
    total = rows * width
    first = row_start * width
    dev = scene.device
    want = [debug_mode] if modes is None else list(modes)
    out = {m: torch.empty((total, 4), dtype=torch.float32, device=dev)
           for m in want}
    counts = torch.empty((total, 2), dtype=torch.int32, device=dev)
    for c0 in range(0, total, PLAIN_CHUNK):
        pix = torch.arange(c0, min(c0 + PLAIN_CHUNK, total), device=dev)
        hit = debug_hit(scene, pix % width, (first + pix) // width,
                        width=width, height=height)
        for m in want:
            out[m][pix] = debug_colors(scene, hit, m, debug_scale)
        counts[pix] = torch.stack([hit["boxes"], hit["tris"]],
                                  dim=1).to(torch.int32)
    out = {m: c.reshape(rows, width, 4) for m, c in out.items()}
    counts = counts.reshape(rows, width, 2)
    return (out if modes is not None else out[debug_mode]), counts


class CudaDebug(CudaKernel):
    """Wrapper of the CUDA kernel: builds ``csrc/debug.cu`` at first use,
    checks every tensor it hands over, launches on the current stream and
    counts its launches in ``launches``. It reads the megakernel's tables
    (``kernel_tables``) from global memory, its brute-force rows staged
    once per scene (kept in ``scene.derived``)."""

    symbol = "rt2_render_debug"
    argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_float]
                + [ctypes.c_void_p] * 3)

    def __init__(self, source: Path = PKG / "csrc" / "debug.cu"):
        super().__init__(source)

    def __call__(self, scene: TorchScene, *, width: int, height: int,
                 debug_mode: int, debug_scale: float, row_start: int = 0,
                 rows: int | None = None):
        dev = scene.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
        _require_eligible(scene)
        rows = height if rows is None else rows
        tab = kernel_tables(scene)
        brute = tab["brute"]
        if tab["staged"]:     # packed rows, which the megakernel stages
            brute = scene.derived.get("debug_brute")
            if brute is None:
                brute = scene.derived["debug_brute"] = \
                    stage_brute_rows(tab["brute"])
        n_brute = sum(c for _, c in _brute_ranges(scene))
        texels = scene.tex_quads
        check_launch(dev, width=width, height=height, row_start=row_start,
                     rows=rows, wide_rows=(scene.wide_rows, 128),
                     tri_attr=(scene.tri_attr, 128),
                     mat_rows=(scene.mat_rows, 32),
                     spheres=(tab["spheres"], SPHERE_COLS),
                     scal=(tab["scal"], None), inst=(tab["inst"], INST_COLS),
                     brute=(brute, BRUTE_STAGED),
                     tex_meta=(scene.tex_meta, 4))
        if texels.device != dev or texels.dtype != torch.int32 \
                or not texels.is_contiguous() or texels.dim() != 2 \
                or texels.shape[1] != 4 or scene.tex_meta.shape[0] != 64:
            raise ValueError(f"texels: expected contiguous int32 (n, 4) on "
                             f"{dev}, got {texels.dtype} "
                             f"{tuple(texels.shape)} on {texels.device}")
        if tab["scal"].numel() != 17 or brute.shape[0] < n_brute:
            raise ValueError(f"bad tables: {tab['scal'].numel()} camera "
                             f"floats, {brute.shape[0]} brute rows for "
                             f"{n_brute}")
        for name, x in (("wide_rows", scene.wide_rows), ("brute", brute),
                        ("texels", texels)):
            check_aligned(name, x, 16)
        fn = self.build()
        out = torch.empty((rows, width, 4), dtype=torch.float32,
                          device=dev)
        counts = torch.empty((rows, width, 2), dtype=torch.int32,
                             device=dev)
        err = launch_on(
            dev, fn, scene.wide_rows.data_ptr(), scene.tri_attr.data_ptr(),
            scene.mat_rows.data_ptr(), tab["spheres"].data_ptr(),
            tab["scal"].data_ptr(), tab["inst"].data_ptr(), brute.data_ptr(),
            scene.n_spheres, scene.n_instances, n_brute, width, height,
            row_start, rows, tab["spheres_mode"], scene.sphere_bvh_root,
            texels.data_ptr(), texels.shape[0], scene.tex_meta.data_ptr(),
            int(debug_mode), float(np.float32(debug_scale)), out.data_ptr(),
            counts.data_ptr())
        if err != 0:
            raise RuntimeError(f"debug kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out, counts


#: the process's one handle on the kernel (its ``launches`` count is what
#: chip_smoke.py reads)
CUDA_DEBUG = CudaDebug()
