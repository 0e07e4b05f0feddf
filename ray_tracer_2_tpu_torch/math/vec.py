"""Small-vector math on trailing-axis-3 tensors (port of
``ray_tracer_2_tpu/math/vec.py``).

Sums over the three components are written out as ``(x + y) + z`` rather
than ``torch.sum``: a reduction may pick another order per device, and the
CUDA kernel (``csrc/megakernel.cu``) uses exactly this order, so the plain
version and the kernel round alike.
"""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False):
    s = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]
    return s[..., None] if keepdim else s


def normalize(v: torch.Tensor) -> torch.Tensor:
    """WGSL ``normalize`` (no epsilon guard)."""
    return v / torch.sqrt(dot(v, v, keepdim=True))


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """WGSL ``reflect``: i - 2*dot(i,n)*n."""
    return i - (2.0 * dot(i, n, keepdim=True)) * n


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """WGSL ``mix``: a + (b - a) * t."""
    return a + (b - a) * t
