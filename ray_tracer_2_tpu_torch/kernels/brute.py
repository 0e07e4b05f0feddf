"""Brute-force closest hit for small instance groups (port of
``ray_tracer_2_tpu/kernels/brute.py`` and of the TPU kernel
``ray_tracer_2_tpu/kernels/pallas_brute.py``).

An instance group of at most ``BRUTE_MAX_TRIS`` triangles is not
traversed: every ray is tested against every triangle of the group, and
the nearest hit wins (lowest index on a tie). Two implementations of one
function, chosen by the device the tensors live on, never by a switch:

* ``brute_force_intersect_plain`` — the plain PyTorch version, the
  reference's XLA path (``brute.py:39``) op for op: (rays x triangles)
  crosses through ``kernels/intersect.ray_triangle`` in chunks of
  triangles, argmin within a chunk, a strict ``<`` across chunks. It
  serves CPU tensors and is what the plain megakernel's prepass runs.
* ``CUDA_BRUTE`` — the hand-written CUDA kernel (``csrc/brute.cu``, its
  staged row and pair test in ``csrc/brute.cuh``): the group's packed
  table (``pack_brute_table``) is staged in shared memory with each
  triangle's edges and normal computed once, and every thread walks it
  with one ray in registers. It serves CUDA tensors; there is no
  fallback. The megakernel's segment prepass runs the same
  ``brute.cuh`` test on the same staged rows inside
  ``csrc/megakernel.cu``, one ray per lane, so on the render path the loop
  runs as part of each megakernel launch (counted on the device:
  ``CUDA_MEGAKERNEL.prepass_counts``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ray_tracer_2_tpu_torch.kernels.cuda_build import (
    PKG, CudaKernel, check_aligned, launch_on,
)
from ray_tracer_2_tpu_torch.kernels.intersect import INF, ray_triangle
from ray_tracer_2_tpu_torch.scene.material import MaterialFlag
from ray_tracer_2_tpu_torch.scene.render_scene import TorchScene

#: instance groups at or below this many triangles take the brute-force
#: path instead of their wide BVH (reference ``brute.py:BRUTE_MAX_TRIS``)
BRUTE_MAX_TRIS = 256
#: columns of the packed table (reference ``_brute_pallas``): v0, v1, v2,
#: the canonical material id, the cull flag, padding
TABLE_COLS = 16
#: triangles per step of the plain version's loop (the reference's chunk)
CHUNK = 512
#: elements of one (rays x triangles) temporary of the plain version; its
#: rays go in blocks sized by it
PLAIN_ELEMS = 1 << 24


def pack_brute_table(scene: TorchScene, tri_offset: int,
                     tri_count: int) -> torch.Tensor:
    """The (tri_count, 16) float32 table of triangles
    [tri_offset, tri_offset + tri_count) that the kernel reads (reference
    ``_brute_pallas``, ``brute.py:110-117``): model-space v0, v1, v2, the
    canonical material id (no instance delta) and 1.0 where the backface
    is culled, i.e. unless the material is glass. Kept in
    ``scene.derived``."""
    key = ("brute_table", int(tri_offset), int(tri_count))
    cached = scene.derived.get(key)
    if cached is not None:
        return cached
    sl = slice(tri_offset, tri_offset + tri_count)
    mats = scene.tri_mat[sl].long()
    cull = (scene.mat_rows[mats, 21] != float(MaterialFlag.GLASS))
    tab = torch.cat([scene.tri_v0[sl], scene.tri_v1[sl], scene.tri_v2[sl],
                     mats.to(torch.float32)[:, None],
                     cull.to(torch.float32)[:, None],
                     torch.zeros((tri_count, TABLE_COLS - 11),
                                 dtype=torch.float32, device=scene.device)],
                    dim=1).contiguous()
    scene.derived[key] = tab
    return tab


def stage_brute_rows(packed: torch.Tensor) -> torch.Tensor:
    """Packed table rows (n, 16) as the (n, 16) rows the kernels' loop
    reads (``csrc/brute.cuh:stage_row``), bit for bit: four 16-byte words
    (v0, material), (e1, cull), (e2, 0), (n, 0), with e1 = v1 - v0,
    e2 = v2 - v0 and n = e1 x e2 in ``ray_triangle``'s operations. The
    kernels stage their rows in shared memory themselves; the megakernel
    reads these from global memory when a scene's tables pass its
    shared-memory budget."""
    v0, v1, v2 = packed[:, 0:3], packed[:, 3:6], packed[:, 6:9]
    e1, e2 = v1 - v0, v2 - v0
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    zero = torch.zeros_like(packed[:, 0:1])
    return torch.cat([v0, packed[:, 9:10], e1, packed[:, 10:11], e2, zero,
                      n, zero], dim=1).contiguous()


def brute_force_intersect(scene: TorchScene, origin, direction,
                          tri_offset: int, tri_count: int) -> dict:
    """Closest hit over triangles [tri_offset, tri_offset + tri_count) for
    (B, 3) model-space rays. Returns the reference's record: ``dst`` (INF
    on a miss), ``tri`` (global id, -1 on a miss), ``u``, ``v``, ``det``,
    ``mat`` (canonical id) and ``stats`` ((B, 2) int32, column 1 the
    triangles streamed). CPU tensors take the plain version, CUDA tensors
    the kernel."""
    if origin.device.type == "cpu":
        return brute_force_intersect_plain(scene, origin, direction,
                                           tri_offset, tri_count)
    if origin.device.type != "cuda":
        raise ValueError(f"no implementation for device {origin.device}")
    B = origin.shape[0]
    rays = torch.cat([origin, direction,
                      torch.zeros((B, 2), dtype=torch.float32,
                                  device=origin.device)], dim=1).contiguous()
    out = CUDA_BRUTE(rays, pack_brute_table(scene, tri_offset, tri_count),
                     tri_count)
    return dict(kernel_record(out, tri_offset),
                stats=_stats(B, tri_count, out.device))


def kernel_record(out: torch.Tensor, tri_offset: int = 0) -> dict:
    """The kernel's (B, 8) output [dst u v det mat tri_local 0 0] as the
    record's fields, ``tri`` global (-1 on a miss)."""
    dst = out[:, 0]
    tri = torch.where(dst < INF, tri_offset + out[:, 5].long(), -1)
    return dict(dst=dst, tri=tri, u=out[:, 1], v=out[:, 2], det=out[:, 3],
                mat=out[:, 4].long())


def _stats(B: int, tri_count: int, dev) -> torch.Tensor:
    stats = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    stats[:, 1] = tri_count
    return stats


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def brute_force_intersect_plain(scene: TorchScene, origin, direction,
                                tri_offset: int, tri_count: int) -> dict:
    """The plain PyTorch version of ``brute_force_intersect`` (any device):
    the reference's XLA loop over chunks of ``CHUNK`` triangles."""
    B, dev = origin.shape[0], origin.device
    dst = torch.full((B,), INF, dtype=torch.float32, device=dev)
    tri = torch.full((B,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros_like(dst)
    v = torch.zeros_like(dst)
    det = torch.zeros_like(dst)
    mat = torch.zeros_like(tri)
    flags = scene.mat_rows[:, 21]
    block = PLAIN_ELEMS // CHUNK
    for start in range(tri_offset, tri_offset + tri_count, CHUNK):
        end = min(start + CHUNK, tri_offset + tri_count)
        v0 = scene.tri_v0[start:end][None]
        v1 = scene.tri_v1[start:end][None]
        v2 = scene.tri_v2[start:end][None]
        mats = scene.tri_mat[start:end].long()
        cull = (flags[mats] != float(MaterialFlag.GLASS))[None]
        for r0 in range(0, B, block):
            r = slice(r0, min(r0 + block, B))
            _, d_, u_, v_, det_ = ray_triangle(
                origin[r, None], direction[r, None], v0, v1, v2, cull)
            k = torch.argmin(d_, dim=1, keepdim=True)
            pick = lambda x: x.gather(1, k)[:, 0]
            dk = pick(d_)
            better = dk < dst[r]
            dst[r] = torch.where(better, dk, dst[r])
            tri[r] = torch.where(better, start + k[:, 0], tri[r])
            u[r] = torch.where(better, pick(u_), u[r])
            v[r] = torch.where(better, pick(v_), v[r])
            det[r] = torch.where(better, pick(det_), det[r])
            mat[r] = torch.where(better, mats[k[:, 0]], mat[r])
    return dict(dst=dst, tri=tri, u=u, v=v, det=det, mat=mat,
                stats=_stats(B, tri_count, dev))


# --------------------------------------------------------------------------
# CUDA kernel (csrc/brute.cu), built by kernels/cuda_build.py
# --------------------------------------------------------------------------
class CudaBrute(CudaKernel):
    """Wrapper of the brute-force CUDA kernel: builds ``csrc/brute.cu`` at
    first use, checks every tensor it hands over, launches on the current
    stream and counts its launches in ``launches``."""

    symbol = "rt2_brute_intersect"
    argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

    def __init__(self, source: Path = PKG / "csrc" / "brute.cu"):
        super().__init__(source)

    def __call__(self, rays: torch.Tensor, tris: torch.Tensor,
                 n_tris: int) -> torch.Tensor:
        """``pallas_brute_intersect``: rays (B, 8) [o3 d3 pad2], tris
        (T, 16) with T >= n_tris. Returns (B, 8) [dst, u, v, det, mat,
        tri_local, 0, 0]."""
        dev = rays.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
        for name, x, cols in (("rays", rays, 8), ("tris", tris, TABLE_COLS)):
            if x.device != dev or x.dtype != torch.float32 \
                    or not x.is_contiguous() or x.dim() != 2 \
                    or x.shape[1] != cols:
                raise ValueError(f"{name}: expected contiguous float32 "
                                 f"(n, {cols}) on {dev}, got {x.dtype} "
                                 f"{tuple(x.shape)} on {x.device}")
            check_aligned(name, x, 16)
        if not 0 <= n_tris <= tris.shape[0]:
            raise ValueError(f"n_tris {n_tris} outside the table's "
                             f"{tris.shape[0]} rows")
        out = torch.empty((rays.shape[0], 8), dtype=torch.float32,
                          device=dev)
        err = launch_on(dev, self.build(), rays.data_ptr(), tris.data_ptr(),
                        int(n_tris), rays.shape[0], out.data_ptr())
        if err != 0:
            raise RuntimeError(f"brute kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out


#: the process's one handle on the kernel (its counts are what
#: chip_smoke.py reads)
CUDA_BRUTE = CudaBrute()
