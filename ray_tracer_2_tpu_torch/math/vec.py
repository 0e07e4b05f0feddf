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


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` on (..., 3): ``a1 b2 - a2 b1``, ``a2 b0 - a0 b2``,
    ``a0 b1 - a1 b0``."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """WGSL ``normalize`` (no epsilon guard)."""
    return v / torch.sqrt(dot(v, v, keepdim=True))


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """WGSL ``reflect``: i - 2*dot(i,n)*n."""
    return i - (2.0 * dot(i, n, keepdim=True)) * n


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, +-0 or 1, and NaN stays NaN (``torch.sign`` maps
    NaN to 0)."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, x))


def refract(i: torch.Tensor, n: torch.Tensor, eta) -> torch.Tensor:
    """WGSL ``refract(i, n, eta)`` (reference ``math/vec.py:refract``): the
    refracted direction, or the zero vector on total internal reflection.
    ``eta`` is (..., 1) against (..., 3) ``i``/``n``."""
    cos_i = dot(n, i, keepdim=True)
    k = 1.0 - (eta * eta) * (1.0 - cos_i * cos_i)
    refr = eta * i - (eta * cos_i + torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, torch.zeros_like(refr), refr)


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """WGSL ``mix``: a + (b - a) * t."""
    return a + (b - a) * t
