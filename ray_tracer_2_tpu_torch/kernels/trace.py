"""Shading helpers shared by the plain renderer, the camera ray basis and
the debug modes' plain version (port of ``ray_tracer_2_tpu/kernels/trace.py``:
``camera_ray_basis`` :308, ``debug_trace_pixels`` :384).

Physics parity (WGSL line refs): environment light :214-221, Schlick
reflectance :208-212, debug modes :502-573.

The debug modes trace one unjittered primary ray a pixel to its closest
hit, the megakernel's segment hit (``kernels/megakernel.py:_intersect``:
the dense sphere prepass, the brute-force groups, each wide-BVH instance,
the sphere BVH), and colour it: 1 the normal as ``n / 2 + 1 / 2``, or the
normal map's texel where the material has one; 2 depth over the scale; 3
the UV; 4 the focus (green past scale / 100, else grey of the depth);
5-7 heat maps of the traversal's work; any other mode magenta. The
counters of the heat maps, per ray:

* **node tests** (mode 5, blue in 7): child boxes tested, ``k`` for every
  wide row evaluated (32-ary rows of f16 boxes; ``Visits.boxes`` of
  ``csrc/trace.cuh``), the sphere BVH's boxes included. The reference
  counts binary BVH nodes visited (its ``traverse.py``, which the port
  does not have), so on a scene with a wide-BVH instance or a sphere BVH
  the two heat maps differ by design;
* **triangle tests** (mode 6, red in 7): each brute-force group's triangle
  count, as the reference counts it (``brute.py:98,126``), plus the
  triangles of every triangle leaf visited (its ``COL_COUNT``, at most 8).
  Spheres count nothing, dense or in the sphere BVH, as in the reference.

On a scene of brute-force groups and spheres alone (``room``, ``metal``)
the two packages count the same things, so modes 5-7 agree exactly.
``csrc/debug.cu`` computes the same on the card (``kernels/debug.py``).
"""
from __future__ import annotations

import torch

from ray_tracer_2_tpu_torch.kernels.texture import sample_bilinear_quads
from ray_tracer_2_tpu_torch.math.vec import lerp, normalize

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


def camera_ray_basis(scene, x, y, width: int, height: int):
    """The camera's origin, right and up axes, and the focus-plane point of
    each pixel (x, y) (ray_tracer.wgsl:479-485): (3,), (3,), (3,), (B, 3).
    The divisor is ``max(size - 1, 1)``, so a one-pixel-wide image stays
    finite."""
    cam, vp = scene.cam_to_world, scene.view_params
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=cam.device)
    u0 = x.to(torch.float32) / f32(float(max(width - 1, 1)))
    u1 = y.to(torch.float32) / f32(float(max(height - 1, 1)))
    lf0 = (u0 - 0.5) * vp[0]
    lf1 = (u1 - 0.5) * vp[1]
    fp = torch.stack([((lf0 * cam[r, 0] + lf1 * cam[r, 1]) + vp[2] * cam[r, 2])
                      + cam[r, 3] for r in range(3)], dim=1)
    return cam[:3, 3], cam[:3, 0], cam[:3, 1], fp


def debug_hit(scene, x, y, *, width: int, height: int) -> dict:
    """The closest hit of each pixel's unjittered primary ray: ``hit``,
    ``dst`` (world distance), ``normal``, ``uv``, ``mat_id`` and the
    per-ray counters ``boxes`` and ``tris`` (see the module docstring)."""
    from ray_tracer_2_tpu_torch.kernels import megakernel as mk
    mk._require_eligible(scene)
    t = mk._Tables(scene, width, height, surface=True)
    origin, _, _, fp = camera_ray_basis(scene, x, y, width, height)
    o = origin.expand(fp.shape[0], 3).contiguous()
    d = normalize(fp - origin)
    kind, dst, _, normal, _, mat, surf, vis = mk._intersect(t, o, d)
    return dict(hit=kind != -1, dst=dst, normal=normal, uv=surf["uv"],
                mat_id=mat, boxes=vis[:, 0], tris=vis[:, 1])


def debug_colors(scene, hit: dict, debug_mode: int,
                 debug_scale: float) -> torch.Tensor:
    """The colour of ``debug_hit``'s record in ``debug_mode``
    (ray_tracer.wgsl:502-573; reference ``debug_trace_pixels``), (B, 4)
    float32; ``debug_scale`` is rounded to float32."""
    dev = hit["dst"].device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    scale = f32(debug_scale)
    n = hit["dst"].shape[0]
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    zeros = torch.zeros_like(ones)
    mask = hit["hit"][:, None]

    def grey(v):
        return torch.stack([v, v, v, ones], dim=-1)

    def masked(c):
        return torch.where(mask, c, torch.zeros_like(c))

    mode = int(debug_mode)
    if mode == 1:   # normals; a normal map's texel where the material has one
        m = gather_material(scene.mat_rows, hit["mat_id"])
        mapped = (m["flag"] == 2.0) & (m["normal_index"] != -1.0)
        tex = sample_bilinear_quads(scene.tex_quads, scene.tex_meta,
                                    m["normal_index"].to(torch.int64),
                                    hit["uv"])
        c = torch.where(mapped[:, None], tex[:, :3],
                        hit["normal"] * 0.5 + 0.5)
        return masked(torch.cat([c, ones[:, None]], dim=1))
    if mode == 2:   # depth
        return masked(grey(hit["dst"] / scale))
    if mode == 3:   # texture coordinates
        return masked(torch.cat([hit["uv"], zeros[:, None], ones[:, None]],
                                dim=1))
    if mode == 4:   # focus distance
        green = torch.stack([zeros, ones, zeros, ones], dim=-1)
        past = (hit["dst"] > scale / f32(100.0))[:, None]
        return masked(torch.where(past, green, grey(hit["dst"])))
    boxes = hit["boxes"].to(torch.float32) / scale
    tris = hit["tris"].to(torch.float32) / scale
    red = torch.stack([ones, zeros, zeros, ones], dim=-1)
    if mode == 5:   # node tests
        return torch.where((boxes > 1.0)[:, None], red, grey(boxes))
    if mode == 6:   # triangle tests
        return torch.where((tris > 1.0)[:, None], red, grey(tris))
    if mode == 7:   # both
        return torch.stack([tris, zeros, boxes, ones], dim=-1)
    return torch.stack([ones, zeros, ones, ones], dim=-1)   # magenta


def debug_trace_pixels(scene, x, y, *, width: int, height: int,
                       debug_mode: int, debug_scale: float) -> torch.Tensor:
    """Deterministic single-ray debug colours of pixels (x, y) (reference
    ``debug_trace_pixels``): (B, 4) float32."""
    return debug_colors(scene, debug_hit(scene, x, y, width=width,
                                         height=height),
                        debug_mode, debug_scale)
