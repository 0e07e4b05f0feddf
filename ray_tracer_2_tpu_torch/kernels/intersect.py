"""Ray–primitive intersection math (port of
``ray_tracer_2_tpu/kernels/intersect.py``; ref: ray_tracer.wgsl:223-351).

Batched over rays and written branch-free, as the reference: "no hit" is a
masked lane holding the INF sentinel (2^127). Each function keeps the
reference's operation order; component sums are written ``(x + y) + z``.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tracer_2_tpu_torch.math.vec import dot

# Constants are kept at their float32 values, so a comparison means the
# same whether a device compares in float32 or in double.
INF = 1.7014118e38                      # 0x1p+127 (ray_tracer.wgsl:132)
EPSILON = float(np.float32(1e-5))       # ray_tracer.wgsl:131
EPS_DET = float(np.float32(1e-8))       # parallel-ray cut of Möller–Trumbore
EPS_SPHERE = float(np.float32(0.001))   # far-root cut (ray_tracer.wgsl:223-256)

#: dense sphere passes switch to the shared-term formula of
#: ``ray_sphere_fast`` at this sphere count; below it the exact
#: reference-order quadratic of ``ray_sphere`` (reference
#: ``kernels/intersect.py:SPHERE_FAST_MIN``)
SPHERE_FAST_MIN = 64


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def ray_sphere(origin, direction, centre, radius):
    """Quadratic sphere test (ray_tracer.wgsl:223-256); shapes broadcast as
    in the reference (``origin`` (B, 1, 3) against ``centre`` (S, 3) gives
    (B, S)). Returns ``(hit, dst, is_inside)``; ``dst`` is INF on a miss."""
    oc = origin - centre
    a = dot(direction, direction)
    b = 2.0 * dot(oc, direction)
    c = dot(oc, oc) - radius * radius
    disc = b * b - (4.0 * a) * c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    dst_near = torch.clamp((-b - s) / (2.0 * a), min=0.0)
    dst_far = (-b + s) / (2.0 * a)
    is_inside = dst_near == 0.0
    hit = (disc >= 0.0) & (dst_far >= EPS_SPHERE)
    dst = torch.where(is_inside, dst_far, dst_near)
    return hit, torch.where(hit, dst, torch.full_like(dst, INF)), is_inside


def ray_sphere_fast(origin, direction, centre, k):
    """Dense (B, S) sphere cross with shared terms (reference
    ``ray_sphere_fast``): ``h = o.d - c.d``, ``|oc|^2 - r^2 = (|o|^2 - 2 o.c)
    + K`` and one ``1/a`` per ray, roots ``(-h -/+ sq) * (1/a)``. The same
    decisions as :func:`ray_sphere` up to reassociation (a grazing hit may
    flip). ``origin``/``direction`` (B, 3), ``centre`` (S, 3), ``k`` (S,)
    the precomputed ``|c|^2 - r^2``. Returns ``(hit, dst, is_inside)``, each
    (B, S)."""
    a = dot(direction, direction)[:, None]
    od = dot(origin, direction)[:, None]
    oo = dot(origin, origin)[:, None]
    cd = dot(centre[None], direction[:, None])
    co = dot(centre[None], origin[:, None])
    h = od - cd
    c = (oo - 2.0 * co) + k[None]
    disc4 = h * h - a * c
    sq2 = torch.sqrt(torch.clamp(disc4, min=0.0))
    inv_a = 1.0 / a
    dst_near = torch.clamp((-h - sq2) * inv_a, min=0.0)
    dst_far = (-h + sq2) * inv_a
    is_inside = dst_near == 0.0
    hit = (disc4 >= 0.0) & (dst_far >= EPS_SPHERE)
    dst = torch.where(is_inside, dst_far, dst_near)
    return hit, torch.where(hit, dst, torch.full_like(dst, INF)), is_inside


def sphere_normal(hit_point, centre, is_inside):
    """Outward (or flipped-inside) unit normal (ray_tracer.wgsl:246-251;
    the spherical UV waits for the texture slice)."""
    n = hit_point - centre
    n = n / torch.sqrt(dot(n, n, keepdim=True))
    return torch.where(is_inside[..., None], -n, n)


def ray_triangle(origin, direction, v0, v1, v2, cull_backface):
    """Möller–Trumbore (ray_tracer.wgsl:258-290), batched over any broadcast
    of rays x triangles. Returns ``(hit, dst, u, v, det)``."""
    edge_ab = v1 - v0
    edge_ac = v2 - v0
    normal = _cross(edge_ab, edge_ac)
    ao = origin - v0
    dao = _cross(ao, direction)
    det = -dot(direction, normal)
    keep = torch.where(cull_backface, det >= EPS_DET,
                       torch.abs(det) >= EPS_DET)
    inv_det = 1.0 / torch.where(keep, det, torch.ones_like(det))
    dst = dot(ao, normal) * inv_det
    u = dot(edge_ac, dao) * inv_det
    v = -dot(edge_ab, dao) * inv_det
    w = (1.0 - u) - v
    hit = keep & (dst > EPSILON) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    return hit, torch.where(hit, dst, torch.full_like(dst, INF)), u, v, det


def ray_aabb_dist(origin, inv_dir, bmin, bmax, t_limit):
    """Slab test returning the entry distance or INF (ray_tracer.wgsl:337-351).
    ``torch.minimum``/``maximum`` propagate NaN like XLA's min/max."""
    t1 = (bmin - origin) * inv_dir
    t2 = (bmax - origin) * inv_dir
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    t_near = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]),
                           tmin[..., 2])
    t_far = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]),
                          tmax[..., 2])
    did_hit = (t_far >= t_near) & (t_near < t_limit) & (t_far > 0.0)
    return torch.where(did_hit, t_near, torch.full_like(t_near, INF))
