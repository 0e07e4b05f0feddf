"""Shading helpers shared by the plain renderer (port of the parts of
``ray_tracer_2_tpu/kernels/trace.py`` the main path reads).

Physics parity (WGSL line refs): environment light :214-221, Schlick
reflectance :208-212.
"""
from __future__ import annotations

import torch

from ray_tracer_2_tpu_torch.math.vec import lerp

# Sky constants (ray_tracer.wgsl:126-130)
SKY_HORIZON = (1.0, 1.0, 1.0, 0.0)
SKY_ZENITH = (0.0788092, 0.36480793, 0.7264151, 0.0)
GROUND_COLOR = (0.35, 0.3, 0.35, 0.0)
SUN_DIR = (0.1, 1.0, 0.1)
SUN_INTENSITY = 0.1
SUN_FOCUS = 500.0


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def smoothstep(edge0: float, edge1: float, x: torch.Tensor) -> torch.Tensor:
    """WGSL ``smoothstep`` (clamped Hermite). The divisor is a float32
    tensor so the division stays a division on every device."""
    t = torch.clamp((x - edge0) / _const(edge1 - edge0, x), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def environment_light(direction: torch.Tensor) -> torch.Tensor:
    """Two-band sky gradient + sun + ground (ray_tracer.wgsl:214-221).
    ``direction`` (..., 3) -> radiance (..., 4)."""
    y = direction[..., 1]
    sky_t = torch.pow(smoothstep(0.0, 0.4, y), 0.35)
    ground_to_sky = smoothstep(-0.01, 0.0, y)
    sky = lerp(_const(SKY_HORIZON, y), _const(SKY_ZENITH, y), sky_t[..., None])
    sd = SUN_DIR
    cos_sun = (direction[..., 0] * sd[0] + direction[..., 1] * sd[1]) \
        + direction[..., 2] * sd[2]
    sun = torch.pow(torch.clamp(cos_sun, min=0.0), SUN_FOCUS) * SUN_INTENSITY
    comp = lerp(_const(GROUND_COLOR, y), sky, ground_to_sky[..., None])
    return comp + (sun * (ground_to_sky >= 1.0))[..., None]


def reflectance(cos_theta: torch.Tensor, ior: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation (ray_tracer.wgsl:208-212; reference
    ``trace._reflectance``). ``(1 - cos)^5`` is written as the products
    JAX lowers it to, ``x4 * x`` with ``x4 = (x x)(x x)``: a ``pow`` would
    round differently."""
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    x2 = x * x
    x4 = x2 * x2
    return r0 + (1.0 - r0) * (x4 * x)


def gather_material(mat_rows: torch.Tensor, mat_id: torch.Tensor) -> dict:
    """One packed-row fetch resolves every material field shading reads
    (layout: scene/render_scene.py ``_pack_material_rows``)."""
    row = mat_rows[mat_id.long()]
    return dict(
        color=row[:, 0:4], emission_color=row[:, 4:8],
        specular_color=row[:, 8:12], absorption=row[:, 12:16],
        absorption_strength=row[:, 16], emission_strength=row[:, 17],
        smoothness=row[:, 18], specular=row[:, 19], ior=row[:, 20],
        flag=row[:, 21], diffuse_index=row[:, 22], normal_index=row[:, 23],
    )
