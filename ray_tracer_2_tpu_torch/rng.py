"""Counter-hash RNG — bit-exact torch port of ``ray_tracer_2_tpu/rng.py``.

The reference kernel threads a mutable u32 seed per pixel through every
random draw (ray_tracer.wgsl:164-206): an LCG step followed by a PCG-style
output permutation, seeded per pixel and frame as
``pixel_index + abs(frames) * 719393`` (ray_tracer.wgsl:475). Because every
stream is a pure function of (pixel, frame), the port needs no
``torch.Generator``: the same counters give the same bits on the CPU, in the
plain PyTorch renderer on the card and in the CUDA kernel (which uses native
``uint32_t``).

PyTorch's ``uint32`` op coverage is partial, so seeds are int64 tensors
holding values in ``[0, 2^32)``; every product is masked back to 32 bits
(no product exceeds 2^62, so int64 never overflows) and shifts take
per-element amounts. Every draw returns ``(value, new_seed)``.

The two NaN guards of the reference port are kept deliberately
(``rand_normal``'s clamped log, ``rand_hemisphere``'s ``>= 0`` flip).
"""
from __future__ import annotations

import torch

_PI = 3.1415926  # the kernel's 7-digit pi (ray_tracer.wgsl:182,203,249)
_M32 = 0xFFFFFFFF


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """0-d float32 tensor on ``like``'s device. Dividing by it is a true
    division on every device (CUDA turns a division by a Python scalar into
    a multiply by its reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def seed_for_pixel(pixel_index: torch.Tensor, frames: int) -> torch.Tensor:
    """``u32(pixel) + u32(abs(frames)) * 719393`` (ray_tracer.wgsl:475)."""
    f = abs(int(frames)) & _M32
    return ((pixel_index.to(torch.int64) & _M32) + f * 719393) & _M32


def next_u32(seed: torch.Tensor):
    """LCG advance + PCG output permutation (ray_tracer.wgsl:195-200).
    Returns ``(bits, new_seed)``, both int64 in ``[0, 2^32)``."""
    seed = (seed * 747796405 + 2891336453) & _M32
    word = (((seed >> ((seed >> 28) + 4)) ^ seed) * 277803737) & _M32
    return (word >> 22) ^ word, seed


def rand(seed: torch.Tensor):
    """Uniform in [0, 1]: u32 / (2^32 - 1) in float32 (ray_tracer.wgsl:164-166;
    the f32 divisor rounds to 2^32)."""
    bits, seed = next_u32(seed)
    return bits.to(torch.float32) / _f32(4294967295.0, bits), seed


def rand_normal(seed: torch.Tensor):
    """Box–Muller, cos branch (ray_tracer.wgsl:181-185); the draw is clamped
    to the smallest positive value before the log, so a zero draw cannot
    poison the pixel with NaN."""
    u1, seed = rand(seed)
    u2, seed = rand(seed)
    theta = (2.0 * _PI) * u1
    rho = torch.sqrt(-2.0 * torch.log(torch.clamp(u2, min=2.33e-10)))
    return rho * torch.cos(theta), seed


def rand_direction(seed: torch.Tensor):
    """Uniform direction: normalize of 3 gaussians in (x, y, z) draw order
    (ray_tracer.wgsl:168-174). Returns ``((..., 3), seed)``."""
    x, seed = rand_normal(seed)
    y, seed = rand_normal(seed)
    z, seed = rand_normal(seed)
    n = torch.sqrt((x * x + y * y) + z * z)
    return torch.stack([x / n, y / n, z / n], dim=-1), seed


def rand_hemisphere(normal: torch.Tensor, seed: torch.Tensor):
    """Direction in the hemisphere of ``normal`` by sign flip
    (ray_tracer.wgsl:176-179), flipping on ``>= 0`` so a draw exactly
    perpendicular to the normal keeps its direction instead of zeroing it."""
    d, seed = rand_direction(seed)
    s = (normal[..., 0] * d[..., 0] + normal[..., 1] * d[..., 1]) \
        + normal[..., 2] * d[..., 2]
    return torch.where((s >= 0.0)[..., None], d, -d), seed


def rand_in_unit_disk(seed: torch.Tensor):
    """Polar disk sample (ray_tracer.wgsl:202-206). Returns ``((..., 2),
    seed)``."""
    u1, seed = rand(seed)
    angle = (u1 * 2.0) * _PI
    r2, seed = rand(seed)
    s = torch.sqrt(r2)
    return torch.stack([torch.cos(angle) * s, torch.sin(angle) * s],
                       dim=-1), seed
