"""Persistent whole-image render (port of
``ray_tracer_2_tpu/kernels/megakernel.py:render_persistent``, its XLA
boundary and the fused boundary of ``kernels/pallas_boundary.py``).

The scenes it takes: any number of mesh instances (shared tables and
material-id deltas included), each traversed in its wide BVH, or, at
``BRUTE_MAX_TRIS`` triangles or fewer, tested triangle by triangle in the
segment prepass (``kernels/brute.py``); spheres, tested densely (up to
``MAX_SPHERES``; from ``SPHERE_FAST_MIN`` with the shared-term formula) or,
where the scene carries a sphere BVH, traversed in it; diffuse, specular,
emissive and glass materials, textured ones (the reference's XLA boundary,
resolve_and_shade :796-884: the diffuse colour sampled from the texel atlas
at the hit's UV, a mesh's interpolated or a sphere's spherical one) and,
with ``normal_maps``, normal maps on mesh hits (the sampled normal rotated
out of the triangle's tangent frame). A segment is the reference's: the dense
sphere prepass, each brute-force group in instance order, then each
wide-BVH instance with its pruning limit seeded from the best world
distance so far, every merge on a strict ``<`` of the world distance; then,
in place of the dense prepass, the sphere BVH in world space, where a
sphere wins an equal distance as it would have in the prepass; then shading
with the hit instance's transform. With ``nee``, next-event estimation at
diffuse vertices (reference resolve_and_shade :888-1082): one light of the
scene's table sampled, its shadow ray tested inline against the prepass on
a scene without a traversal phase (``nee_mode`` 1) or traced as a segment
of its own through every phase (2).

Two implementations of one function, chosen by the device the scene's
tensors live on, never by a switch:

* ``render_plain`` — the plain PyTorch version: a wavefront over the
  frame's pixels. A Python loop walks samples and segments; inside it a
  vectorised loop walks the same 32-ary wide rows (accel/wide.py) with a
  per-ray resume stack. It serves CPU tensors, and ``chip_smoke.py`` holds
  the kernel against it on the card.
* ``CUDA_MEGAKERNEL`` — the hand-written CUDA kernel
  (``csrc/megakernel.cu``, its brute-force loop in ``csrc/brute.cuh``):
  persistent blocks whose lanes trace one segment per turn and refill from
  a per-launch pixel cursor (``csrc/claim.cuh``). It serves CUDA tensors;
  there is no fallback to the plain version. A scene that samples a
  texture (a textured material, or normal maps asked for on a scene that
  has them) runs the kernel's textured forms.

Both count the traversal's work: interior wide-row visits, leaf visits and
child boxes tested (``COUNTS``; on the card the two versions' counts are
equal). Pixel values do not depend on the order pixels are rendered in,
since every draw derives from the pixel id.

Both follow the reference's XLA boundary op for op (same RNG stream, same
sums in the same order) so images agree to float rounding; see
``tests/test_torch_megakernel.py`` and ``tests/test_torch_room2.py`` for
the classes they are held to. The TPU scheduling knobs of the reference
(``lanes``, ``unroll``, ``claim``, ``cohorts``, ``boundaries``, ``log_cap``,
``packet``, ``shade_every``, ``fused_boundary``) leave the image unchanged by
construction and have no counterpart here.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from ray_tracer_2_tpu_torch.accel.packed import COL_COUNT, COL_FIRST
from ray_tracer_2_tpu_torch.accel.wide import (
    COL_BASE, COL_CHILD_AABB, COL_K, COL_LEAF_GEO, COL_MATCULL, COL_SPH_ID,
    MAX_ARITY, N_AABB_COLS, SPH_CHUNK,
)
from ray_tracer_2_tpu_torch import rng
from ray_tracer_2_tpu_torch.kernels.brute import (
    BRUTE_MAX_TRIS, brute_force_intersect_plain, pack_brute_table,
    stage_brute_rows,
)
from ray_tracer_2_tpu_torch.kernels.cuda_build import (
    PKG, CudaKernel, check_aligned, check_launch, frame_seed, launch_on,
    launch_scratch, load_library,
)
from ray_tracer_2_tpu_torch.kernels.intersect import (
    EPS_DET, EPS_SPHERE, EPSILON, INF, SPHERE_FAST_MIN, closest_sphere,
    sphere_k, sphere_normal, sphere_uv,
)
from ray_tracer_2_tpu_torch.kernels.texture import sample_bilinear_quads
from ray_tracer_2_tpu_torch.kernels.trace import environment_light, \
    gather_material, reflectance
from ray_tracer_2_tpu_torch.math.vec import cross, dot, lerp, normalize, \
    reflect, refract, sign
from ray_tracer_2_tpu_torch.scene.material import MaterialFlag
from ray_tracer_2_tpu_torch.scene.render_scene import SPHERE_BVH_MIN, \
    TorchScene

#: dense prepass capacity: scenes at ``SPHERE_BVH_MIN`` spheres and above
#: carry the sphere BVH (as ``kernels/spheres.py:MAX_SPHERES``)
MAX_SPHERES = SPHERE_BVH_MIN - 1
#: the id a sphere-BVH traversal starts from: no sphere, and it loses every
#: (distance, id) tie (reference ``SPH_SENT``)
SPH_SENT = 0x3FFFFFFF
#: floats per row of the kernel's sphere table (csrc/megakernel.cu
#: kSphStride): centre, radius (``|c|^2 - r^2`` instead where the dense
#: prepass takes the shared-term formula), material
SPHERE_COLS = 5
#: resume-stack capacity of the CUDA kernel (csrc/megakernel.cu kMaxStack)
MAX_STACK = 16
#: pixels per wavefront of the plain version (bounds its memory)
PLAIN_CHUNK = 1 << 18
#: elements of one (rays x spheres) temporary of its dense sphere prepass
PLAIN_ELEMS = 1 << 26
#: floats per instance row of the kernel's instance table (csrc/megakernel.cu
#: kInstCols): w2m[:3, :4], m2w[:3, :4], root row, first triangle,
#: triangle count, material-id delta, brute-force flag, brute table row
INST_COLS = 32
#: floats of a brute-force triangle as the kernel stages it (brute.cuh
#: kRowWords float4 words: v0, both edges, the normal, material, cull)
BRUTE_STAGED = 16
#: the kernel's device counts, in csrc/megakernel.cu's order (kCnt*):
#: brute-force closest-hit calls (one per segment and group, and per inline
#: shadow test and group), launches that ran the prepass, interior wide-row
#: visits, leaf visits, child boxes tested, turns of a warp's lane loop,
#: lanes holding a path summed over those turns, shadow rays of next-event
#: estimation (inline tests and shadow segments)
COUNTS = ("brute_calls", "brute_launches", "rows", "leaves", "boxes",
          "turns", "active_lanes", "shadow_rays")
#: shared memory the kernel stages the sphere, instance and brute-force
#: tables in (csrc/megakernel.cu kDynSmemBytes); a scene whose tables pass
#: it has them read from global memory. Staging costs resident blocks: it
#: measured faster up to 32 KB of tables, level at 39 KB and slower beyond
#: (PERF.md, section 6), so the budget keeps 6 of the general forms' 7
#: blocks resident.
SMEM_BYTES = 36 * 1024

#: floats per row of the light table of next-event estimation (csrc/
#: megakernel.cu kLightCols): kind (1 sphere), v0 (a sphere: centre), v1
#: (a sphere: radius in v1.x), v2, the unit normal cross(v1-v0, v2-v0),
#: radiance
LIGHT_COLS = 16

_F16_MAGIC = 2.0 ** 112          # rebias of f16 exponents onto f32
# absolute and relative slack of the traversal's pruning limit (reference
# megakernel.start_segments): keeps a triangle that ties the prepass hit
_SLACK = float(np.float32(8e-6))
_REL = float(np.float32(1.0 + 4e-6))
# next-event estimation's float32 constants as JAX rounds its Python floats
# (reference resolve_and_shade :924-1003; csrc/megakernel.cu the same
# literals): the shadow test's slack, the d^2 floor, 2 pi, 4 pi, the
# inside-the-light margin
_UNOCC = float(np.float32(1.0 - 1e-3))
_D2_MIN = float(np.float32(1e-12))
_TWO_PI = float(np.float32(2.0 * math.pi))
_FOUR_PI = float(np.float32(4.0 * math.pi))
_SPH_MARGIN = float(np.float32(1.001))


def bvh_instances(scene: TorchScene) -> list:
    """Instances traversed in their wide BVH, in order (reference
    ``_bvh_instances``)."""
    return [i for i, (_, _, c) in enumerate(scene.inst_spans)
            if c > BRUTE_MAX_TRIS]


def brute_instances(scene: TorchScene) -> list:
    """Instances tested triangle by triangle in the prepass, in order."""
    return [i for i, (_, _, c) in enumerate(scene.inst_spans)
            if c <= BRUTE_MAX_TRIS]


def _brute_ranges(scene: TorchScene) -> dict:
    """(first triangle, count) of each distinct brute-force group -> its
    first row in the kernel's staged brute table (instances sharing a
    group share its rows)."""
    ranges = {}
    for i in brute_instances(scene):
        key = scene.inst_spans[i][1:]
        if key not in ranges:
            ranges[key] = sum(c for _, c in ranges)
    return ranges


def dense_spheres(scene: TorchScene) -> int:
    """Spheres the dense prepass tests: all of them, or none where the
    scene carries a sphere BVH."""
    return 0 if scene.sphere_bvh_root >= 0 else scene.n_spheres


def smem_bytes(scene: TorchScene) -> int:
    """Bytes of the tables every segment reads whole: the dense spheres,
    the instance table and the staged brute-force triangles. The kernel
    stages them in shared memory when they fit ``SMEM_BYTES``."""
    n_brute = sum(c for _, c in _brute_ranges(scene))
    return 4 * (dense_spheres(scene) * SPHERE_COLS
                + scene.n_instances * INST_COLS + n_brute * BRUTE_STAGED)


def ineligibility(scene: TorchScene) -> str | None:
    """Why ``scene`` lies outside the ported megakernel, naming the ROADMAP
    item that lifts it where there is one; None if it is inside."""
    if dense_spheres(scene) > MAX_SPHERES:
        return (f"{scene.n_spheres} dense spheres: from {SPHERE_BVH_MIN} a "
                "scene is instantiated with the sphere BVH")
    if (bvh_instances(scene) or scene.sphere_bvh_root >= 0) \
            and scene.wide_depth + 2 > MAX_STACK:
        return f"wide BVHs deeper than {MAX_STACK - 2} levels"
    return None


def samples_textures(scene: TorchScene, normal_maps: bool = False) -> bool:
    """Whether shading ``scene`` samples the texel atlas: a textured
    material, or normal maps asked for on a scene whose materials have
    them (the kernel then runs its textured forms)."""
    return "texture" in scene.shade_classes \
        or (normal_maps and "normal_map" in scene.shade_classes)


def nee_mode(scene: TorchScene, nee: bool, segments: bool = False) -> int:
    """How next-event estimation runs on ``scene`` (reference
    ``_make_parts``): 0 off (not asked for, or no light table); 2 shadow
    segments, each traced as a segment of its own through every phase,
    where the scene has a traversal phase (a wide-BVH instance or the sphere
    BVH) or ``segments`` asks for them (the reference's
    ``RT2_NEE_SEGMENTS=1``, for tests); else 1, the shadow ray tested inline
    against the dense spheres and brute-force groups."""
    if not nee or not scene.lights:
        return 0
    traversal = bool(bvh_instances(scene)) or scene.sphere_bvh_root >= 0
    return 2 if traversal or segments else 1


def light_tables(scene: TorchScene) -> dict:
    """The light table as next-event estimation samples it, once per scene
    (kept in ``scene.derived``), built as the reference builds it in
    resolve_and_shade (:911-922): ``rows`` (n, ``LIGHT_COLS``) float32 on
    the scene's device, ``cdf`` the float32 cumulative area shares (the
    pick counts the entries before the last that a draw reaches), and the
    float32 constants ``c_tri`` = total area / 2 pi and ``c_area`` = total
    area, each rounded once from float64."""
    cached = scene.derived.get("nee_lights")
    if cached is not None:
        return cached
    arr = np.asarray(scene.lights, np.float32)
    lk, lv0 = arr[:, 0], arr[:, 1:4]
    lv1, lv2, lrad = arr[:, 4:7], arr[:, 7:10], arr[:, 10:13]
    larea = arr[:, 13]
    nrm = np.cross(lv1 - lv0, lv2 - lv0)
    nl = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(nl, 1e-30)
    rows = np.concatenate([lk[:, None], lv0, lv1, lv2, nrm, lrad], axis=1)
    total_area = float(larea.sum())
    cdf = np.cumsum(larea) / max(total_area, 1e-30)
    dev = scene.device
    tables = dict(
        rows=torch.from_numpy(rows.astype(np.float32)).to(dev).contiguous(),
        cdf=torch.from_numpy(cdf.astype(np.float32)).to(dev).contiguous(),
        c_tri=float(np.float32(total_area / (2.0 * math.pi))),
        c_area=float(np.float32(total_area)))
    scene.derived["nee_lights"] = tables
    return tables


def _require_eligible(scene: TorchScene) -> None:
    reason = ineligibility(scene)
    if reason is not None:
        raise NotImplementedError(f"not in the ported slice: {reason}")


def render_persistent(scene: TorchScene, frames: int, *, width: int,
                      height: int, bounces: int, rays_per_pixel: int,
                      skybox: bool, antialias: bool = False,
                      row_start: int = 0, rows: int | None = None,
                      nee: bool = False, nee_segments: bool = False,
                      normal_maps: bool = False):
    """Render ``rows`` image rows from ``row_start`` (``width``/``height``
    describe the full image). Returns ``((rows, width, 4) float32 image,
    int64 0-d segment count)`` on the scene's device. CPU scenes take the
    plain version; CUDA scenes take the kernel. ``nee``: next-event
    estimation at diffuse vertices (``nee_mode``; ``nee_segments`` forces
    shadow segments, for tests). ``normal_maps``: the normal maps of the
    scene's materials perturb the shading normal of mesh hits."""
    kw = dict(width=width, height=height, bounces=bounces,
              rays_per_pixel=rays_per_pixel, skybox=skybox,
              antialias=antialias, row_start=row_start, rows=rows, nee=nee,
              nee_segments=nee_segments, normal_maps=normal_maps)
    if scene.device.type == "cpu":
        return render_plain(scene, frames, **kw)
    if scene.device.type == "cuda":
        return CUDA_MEGAKERNEL(scene, frames, **kw)
    raise ValueError(f"no implementation for device {scene.device}")


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
class _Tables:
    """Per-call views of the scene the plain version reads, with the small
    constants as float32 0-d tensors on the scene's device (a division by
    one stays a true division on CUDA)."""

    def __init__(self, scene: TorchScene, width: int, height: int,
                 nee: int = 0, normal_maps: bool = False):
        dev = scene.device
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        self.scene = scene
        self.dev = dev
        self.cam = scene.cam_to_world
        self.view = scene.view_params
        self.bvh = bvh_instances(scene)
        self.brute = brute_instances(scene)
        self.glass = "glass" in scene.shade_classes
        # textured diffuse colour, normal maps: what the scene's classes
        # and the caller compile in (reference resolve_and_shade :796-811)
        self.tex = "texture" in scene.shade_classes
        self.nmap = normal_maps and "normal_map" in scene.shade_classes
        self.depth = scene.wide_depth + 2
        self.w1 = f32(float(max(width - 1, 1)))
        self.h1 = f32(float(max(height - 1, 1)))
        self.inv_w = float(np.float32(1.0) / np.float32(width))
        self.one = f32(1.0)
        self.sphere_k = sphere_k(scene.sphere_pos, scene.sphere_radius)
        # next-event estimation: its mode and light table
        self.nee = nee
        if nee:
            lt = light_tables(scene)
            self.lights, self.cdf = lt["rows"], lt["cdf"][:-1]
            self.c_tri, self.c_area = f32(lt["c_tri"]), f32(lt["c_area"])
        # traversal work, as the kernel counts it
        self.rows = 0
        self.leaves = 0
        self.boxes = torch.zeros((), dtype=torch.int64, device=dev)
        self.shadow_rays = torch.zeros((), dtype=torch.int64, device=dev)
        # texel quads fetched: one per textured diffuse colour and one per
        # normal map a hit takes
        self.taps = torch.zeros((), dtype=torch.int64, device=dev)


def _affine(m, v, translate: bool):
    """Rows of ``m[:3, :3] @ v`` as ``(m0 x + m1 y) + m2 z`` (+ ``m[:, 3]``)."""
    out = torch.stack([(m[r, 0] * v[:, 0] + m[r, 1] * v[:, 1])
                       + m[r, 2] * v[:, 2] for r in range(3)], dim=1)
    return out + m[:3, 3] if translate else out


def _camera_ray(t: _Tables, x, y, seed, antialias: bool):
    """frag() camera rays (megakernel.py camera_ray; ray_tracer.wgsl:473-500):
    two disk draws, plus two jitter draws with ``antialias``."""
    cam, vp = t.cam, t.view
    u0 = x.to(torch.float32) / t.w1
    u1 = y.to(torch.float32) / t.h1
    lf0 = (u0 - 0.5) * vp[0]
    lf1 = (u1 - 0.5) * vp[1]
    fp = torch.stack([((lf0 * cam[r, 0] + lf1 * cam[r, 1]) + vp[2] * cam[r, 2])
                      + cam[r, 3] for r in range(3)], dim=1)
    right, up, origin = cam[:3, 0], cam[:3, 1], cam[:3, 3]
    if antialias:
        ju, seed = rng.rand(seed)
        jv, seed = rng.rand(seed)
        du = ((ju - 0.5) * vp[0]) / t.w1
        dv = ((jv - 0.5) * vp[1]) / t.h1
        fp = (fp + right * du[:, None]) + up * dv[:, None]
    dj, seed = rng.rand_in_unit_disk(seed)
    dj = (dj * t.scene.defocus_strength) * t.inv_w
    o = (origin + right * dj[:, 0:1]) + up * dj[:, 1:2]
    vj, seed = rng.rand_in_unit_disk(seed)
    vj = (vj * t.scene.diverge_strength) * t.inv_w
    fpj = (fp + right * vj[:, 0:1]) + up * vj[:, 1:2]
    return o, normalize(fpj - o), seed


def _unpack_f16(bits):
    """f16 bit patterns (int64) -> float32 by integer rebias
    (megakernel.py f16_bits_to_f32)."""
    f = ((bits & 0x8000) << 16) | ((bits & 0x7FFF) << 13)
    f = torch.where(f >= 1 << 31, f - (1 << 32), f)
    return f.to(torch.int32).view(torch.float32) * _F16_MAGIC


def _wide_eval(rows, om, inv, limit):
    """Wide rows (n, 128) against rays: (hit mask, nearest hit child (first
    index on ties), least entry distance over the other hit children)
    (megakernel.py wide_eval / slab_blocked)."""
    a = MAX_ARITY
    u = rows[:, COL_CHILD_AABB:COL_CHILD_AABB + N_AABB_COLS].contiguous() \
        .view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lo, hi = _unpack_f16(u & 0xFFFF), _unpack_f16(u >> 16)
    t1 = [(lo[:, i * a:(i + 1) * a] - om[:, i:i + 1]) * inv[:, i:i + 1]
          for i in range(3)]
    t2 = [(hi[:, i * a:(i + 1) * a] - om[:, i:i + 1]) * inv[:, i:i + 1]
          for i in range(3)]
    mn = [torch.minimum(p, q) for p, q in zip(t1, t2)]
    mx = [torch.maximum(p, q) for p, q in zip(t1, t2)]
    tn = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    tf = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    lane = torch.arange(a, device=rows.device)
    k = rows[:, COL_K].to(torch.int64)
    hit = (tf >= tn) & (tn < limit[:, None]) & (tf > 0.0) \
        & (lane[None, :] < k[:, None])
    dn = torch.where(hit, tn, torch.full_like(tn, INF))
    mask = (hit.to(torch.int64) << lane).sum(dim=1)
    c_min = torch.argmin(dn, dim=1)
    dn2 = torch.where(lane[None, :] == c_min[:, None],
                      torch.full_like(dn, INF), dn).amin(dim=1)
    return mask, c_min, dn2


def _leaf_test(rows, om, dm, best):
    """Blocked 8-triangle Möller–Trumbore on leaf rows (megakernel.py
    traversal_step). Returns (better, dst, u, v, det, tri, mat) of the
    nearest hit closer than ``best`` (first slot on ties)."""
    g = [rows[:, COL_LEAF_GEO + 8 * c:COL_LEAF_GEO + 8 * c + 8]
         for c in range(12)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz = g
    dmx, dmy, dmz = dm[:, 0:1], dm[:, 1:2], dm[:, 2:3]
    omx, omy, omz = om[:, 0:1], om[:, 1:2], om[:, 2:3]
    det = -((dmx * nx + dmy * ny) + dmz * nz)
    mc = rows[:, COL_MATCULL:COL_MATCULL + 8].to(torch.int64)
    cull = (mc & 1) == 1
    keep = torch.where(cull, det >= EPS_DET, torch.abs(det) >= EPS_DET)
    inv = 1.0 / torch.where(keep, det, torch.ones_like(det))
    aox, aoy, aoz = omx - v0x, omy - v0y, omz - v0z
    daox = aoy * dmz - aoz * dmy
    daoy = aoz * dmx - aox * dmz
    daoz = aox * dmy - aoy * dmx
    dst = ((aox * nx + aoy * ny) + aoz * nz) * inv
    u = ((e2x * daox + e2y * daoy) + e2z * daoz) * inv
    v = -((e1x * daox + e1y * daoy) + e1z * daoz) * inv
    w = (1.0 - u) - v
    hit = keep & (dst > EPSILON) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0) \
        & (dst < best[:, None])
    dstw = torch.where(hit, dst, torch.full_like(dst, INF))
    j = torch.argmin(dstw, dim=1, keepdim=True)
    pick = lambda x: x.gather(1, j)[:, 0]
    first = rows[:, COL_FIRST].to(torch.int64)
    return (hit.any(dim=1), pick(dstw), pick(u), pick(v), pick(det),
            first + j[:, 0], pick(mc) >> 1)


def _sphere_leaf_test(rows, o, d, best, best_id):
    """Blocked 8-sphere quadratic on sphere leaf rows (megakernel.py
    traversal_step :481-521): the dense test's arithmetic with ``r^2`` from
    the row. Returns (better, dst, id) of the leaf's nearest hit, lowest id
    among equal distances, where it beats ``(best, best_id)`` in (distance,
    id) order."""
    g = [rows[:, COL_LEAF_GEO + SPH_CHUNK * c:
              COL_LEAF_GEO + SPH_CHUNK * (c + 1)] for c in range(4)]
    cx, cy, cz, r2 = g
    sid = rows[:, COL_SPH_ID:COL_SPH_ID + SPH_CHUNK]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ocx, ocy, ocz = o[:, 0:1] - cx, o[:, 1:2] - cy, o[:, 2:3] - cz
    a = (dx * dx + dy * dy) + dz * dz
    b = 2.0 * ((ocx * dx + ocy * dy) + ocz * dz)
    c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r2
    disc = b * b - (4.0 * a) * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    dn = torch.clamp((-b - sq) / (2.0 * a), min=0.0)
    df = (-b + sq) / (2.0 * a)
    hit = (disc >= 0.0) & (df >= EPS_SPHERE)
    dst = torch.where(dn == 0.0, df, dn)
    sent = float(SPH_SENT)
    dstw = torch.where(hit, dst, torch.full_like(dst, INF))
    mn = dstw.amin(dim=1)
    idmn = torch.where(hit & (dstw == mn[:, None]), sid,
                       torch.full_like(sid, sent)).amin(dim=1)
    better = hit.any(dim=1) & ((mn < best) | ((mn == best)
                                               & (idmn < best_id.to(mn.dtype))))
    return better, mn, idmn.to(torch.int64)


def _traverse(t: _Tables, root, om, dm, limit, spheres: bool = False):
    """Closest hit of model-space rays in the wide BVH whose root row is
    ``root``, pruned at
    ``limit`` (megakernel.py wide_enter + traversal_step): enter the nearest
    hit child, push the other hits as (base, mask, least entry distance),
    pop the deepest entry still closer than the best hit, lowest child
    index first. Returns (dst, u, v, det, tri (-1 = none), mat). With
    ``spheres`` the tree is the sphere BVH and the rays are world-space:
    its leaves take ``_sphere_leaf_test``, ``tri`` is the winning sphere's
    id (``SPH_SENT`` = none) and u, v, det and mat stay 0."""
    n, dev, depth = om.shape[0], om.device, t.depth
    inv = 1.0 / dm
    best = limit.clone()
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)
    bdet = torch.zeros_like(best)
    tri = torch.full((n,), SPH_SENT if spheres else -1, dtype=torch.int64,
                     device=dev)
    mat = torch.zeros(n, dtype=torch.int64, device=dev)
    sb = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    sm = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    sd = torch.zeros((n, depth), dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cols = torch.arange(depth, device=dev)
    bits = torch.arange(MAX_ARITY, device=dev)

    def descend(lanes, rows):
        """Evaluate wide rows for ``lanes``; push, enter the nearest hit
        child. Returns the lanes whose row had no hit child."""
        mask, c_min, dn2 = _wide_eval(rows, om[lanes], inv[lanes],
                                      best[lanes])
        t.rows += lanes.numel()
        t.boxes += rows[:, COL_K].to(torch.int64).clamp(0, MAX_ARITY).sum()
        base = rows[:, COL_BASE].to(torch.int64)
        has = mask != 0
        rem = mask & ~(1 << c_min)
        push = has & (rem != 0)
        pl, at = lanes[push], sp[lanes[push]]
        sb[pl, at] = base[push]
        sm[pl, at] = rem[push]
        sd[pl, at] = dn2[push]
        sp[pl] = at + 1
        cur[lanes[has]] = base[has] + c_min[has]
        return lanes[~has]

    all_lanes = torch.arange(n, device=dev)
    descend(all_lanes, root.expand(n, -1))
    act = all_lanes[cur >= 0]
    while act.numel():
        rows = t.scene.wide_rows[cur[act]]
        leaf = rows[:, COL_COUNT] > 0.5
        done = [act[leaf]]
        if bool((~leaf).any()):
            done.append(descend(act[~leaf], rows[~leaf]))
        lf = act[leaf]
        t.leaves += lf.numel()
        if lf.numel() and spheres:
            better, d_, id_ = _sphere_leaf_test(rows[leaf], om[lf], dm[lf],
                                                best[lf], tri[lf])
            bl = lf[better]
            best[bl], tri[bl] = d_[better], id_[better]
        elif lf.numel():
            better, d_, u_, v_, det_, tri_, mat_ = _leaf_test(
                rows[leaf], om[lf], dm[lf], best[lf])
            bl = lf[better]
            best[bl], bu[bl], bv[bl] = d_[better], u_[better], v_[better]
            bdet[bl], tri[bl], mat[bl] = det_[better], tri_[better], \
                mat_[better]
        fin = torch.cat(done)
        if fin.numel():
            live = (cols[None, :] < sp[fin, None]) \
                & (sd[fin] < best[fin, None])
            pstar = torch.where(live, cols, -1).amax(dim=1)
            ok = pstar >= 0
            cur[fin[~ok]] = -1
            sp[fin[~ok]] = 0
            pl, ps = fin[ok], pstar[ok]
            m = sm[pl, ps]
            low = ((m[:, None] >> bits) & 1).argmax(dim=1)
            prem = m & (m - 1)
            cur[pl] = sb[pl, ps] + low
            sm[pl, ps] = torch.where(prem != 0, prem, m)
            sp[pl] = ps + (prem != 0).to(torch.int64)
        act = act[cur[act] >= 0]
    return best, bu, bv, bdet, tri, mat


def _affine_rows(m, v, translate: bool):
    """``_affine`` with one (4, 4) matrix per ray (``m`` (n, 4, 4))."""
    out = torch.stack([(m[:, r, 0] * v[:, 0] + m[:, r, 1] * v[:, 1])
                       + m[:, r, 2] * v[:, 2] for r in range(3)], dim=1)
    return out + m[:, :3, 3] if translate else out


def _intersect(t: _Tables, o, d):
    """Segment hit (megakernel.py segment_prepass, start_segments,
    _advance_impl): the dense sphere prepass, each brute-force group in
    instance order, then each wide-BVH instance with its pruning limit
    seeded from the best world distance so far; every merge keeps the
    earlier hit on an equal world distance. A scene with a sphere BVH skips
    the dense prepass and traverses the spheres last, in world space, pruned
    at the best world distance; there a sphere takes an equal distance, as
    it would have when tested first. Returns (kind: -1 miss / -2 sphere /
    >= 0 triangle id, world distance, point, normal, backface, material
    id, surface): with textures or normal maps (``t.tex``, ``t.nmap``) the
    surface holds the hit's UV (a mesh's interpolated, a sphere's from its
    normal) and, for normal maps, a mesh hit's tangent through its
    instance's transform, normalised, and handedness; else None."""
    n, scene, dev = o.shape[0], t.scene, t.dev
    kind = torch.full((n,), -1, dtype=torch.int64, device=dev)
    seg_dst = torch.full((n,), INF, dtype=torch.float32, device=dev)
    point = torch.zeros_like(o)
    normal = torch.zeros_like(o)
    smat = torch.zeros(n, dtype=torch.int64, device=dev)
    # sphere: 1 when the ray starts inside; triangle: the instance id
    flag = torch.zeros(n, dtype=torch.int64, device=dev)
    u = torch.zeros_like(seg_dst)
    v = torch.zeros_like(seg_dst)
    det = torch.zeros_like(seg_dst)

    def sphere_hit(won, sd, idx, inside):
        """Make sphere ``idx`` at distance ``sd`` the segment's hit where
        ``won``."""
        nonlocal kind, seg_dst, point, normal, smat, flag
        hp = o + d * sd[:, None]
        kind = torch.where(won, -2, kind)
        seg_dst = torch.where(won, sd, seg_dst)
        point = torch.where(won[:, None], hp, point)
        normal = torch.where(
            won[:, None], sphere_normal(hp, scene.sphere_pos[idx], inside),
            normal)
        smat = torch.where(won, scene.sphere_mat[idx].to(torch.int64), smat)
        flag = torch.where(won, inside.to(torch.int64), flag)

    if dense_spheres(scene):
        sd, idx, inside = closest_sphere(o, d, scene.sphere_pos,
                                         scene.sphere_radius, t.sphere_k,
                                         PLAIN_ELEMS)
        sphere_hit(sd < INF, sd, idx, inside)

    def instance_ray(i):
        w2m = scene.inst_world_to_model[i]
        return _affine(w2m, o, True), normalize(_affine(w2m, d, False))

    def merge(i, om, dm, dst, tri, mat, hu, hv, hdet):
        nonlocal kind, seg_dst, point, smat, flag, u, v, det
        wh = _affine(scene.inst_model_to_world[i], om + dm * dst[:, None],
                     True)
        wd = torch.sqrt(dot(wh - o, wh - o))
        better = (tri >= 0) & (wd < seg_dst)
        seg_dst = torch.where(better, wd, seg_dst)
        kind = torch.where(better, tri, kind)
        smat = torch.where(better, mat + scene.inst_mat_deltas[i], smat)
        flag = torch.where(better, i, flag)
        u = torch.where(better, hu, u)
        v = torch.where(better, hv, v)
        det = torch.where(better, hdet, det)
        point = torch.where(better[:, None], wh, point)

    for i in t.brute:
        _, tri_off, count = scene.inst_spans[i]
        om, dm = instance_ray(i)
        r = brute_force_intersect_plain(scene, om, dm, tri_off, count)
        merge(i, om, dm, r["dst"], r["tri"], r["mat"], r["u"], r["v"],
              r["det"])
    for i in t.bvh:
        om, dm = instance_ray(i)
        wv = _affine(scene.inst_model_to_world[i], dm, False)
        slack = _SLACK * (1.0 + torch.sqrt(dot(o, o)))
        limit = (seg_dst * _REL + slack) / torch.sqrt(dot(wv, wv))
        best, bu, bv, bdet, tri, mat = _traverse(
            t, scene.wide_rows[scene.wide_roots[i]], om, dm, limit)
        merge(i, om, dm, best, tri, mat, bu, bv, bdet)
    if scene.sphere_bvh_root >= 0:
        # the winner's inside flag by the dense quadratic (reference
        # _sphere_merge), centre and radius from the dense tables
        best, _, _, _, sid, _ = _traverse(
            t, scene.wide_rows[scene.sphere_bvh_root], o, d, seg_dst,
            spheres=True)
        won = sid != SPH_SENT
        sid = torch.where(won, sid, 0)
        oc = o - scene.sphere_pos[sid]
        rad = scene.sphere_radius[sid]
        a = dot(d, d)
        b = 2.0 * dot(oc, d)
        disc = b * b - (4.0 * a) * (dot(oc, oc) - rad * rad)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        inside = torch.clamp((-b - sq) / (2.0 * a), min=0.0) == 0.0
        sphere_hit(won, best, sid, inside)

    mesh = kind >= 0
    surf = dict(uv=torch.zeros((n, 2), dtype=torch.float32, device=dev)) \
        if t.tex or t.nmap else None
    if scene.n_instances:
        attr = scene.tri_attr[torch.clamp(kind, min=0) >> 2] \
            .view(n, 4, 32)[torch.arange(n, device=dev), kind & 3]
        wb = (1.0 - u) - v
        nm = normalize((attr[:, 0:3] * wb[:, None]
                        + attr[:, 3:6] * u[:, None])
                       + attr[:, 6:9] * v[:, None]) * sign(det)[:, None]
        m2w = scene.inst_model_to_world[
            torch.clamp(flag, 0, scene.n_instances - 1)]
        normal = torch.where(mesh[:, None],
                             normalize(_affine_rows(m2w, nm, False)), normal)
        if surf is not None:
            surf["uv"] = (attr[:, 9:11] * wb[:, None]
                          + attr[:, 11:13] * u[:, None]) \
                + attr[:, 13:15] * v[:, None]
        if t.nmap:
            surf["tangent"] = normalize(_affine_rows(m2w, attr[:, 15:18],
                                                     False))
            surf["hand"] = attr[:, 18]
    if surf is not None:
        surf["uv"] = torch.where((kind == -2)[:, None], sphere_uv(normal),
                                 surf["uv"])
    backface = torch.where(kind == -2, flag > 0, det < 0.0)
    return kind, seg_dst, point, normal, backface, smat, surf


def _glass(m, d, trans, seed, dst, point, normal, backface):
    """The glass branch of resolve_and_shade (megakernel.py:826-852;
    ray_tracer.wgsl:414-436): Beer–Lambert absorption on a backface hit, the
    ior flip, Schlick reflectance drawn against only when refraction is
    possible, a random direction, the two lerps and the origin pushed off
    the surface to the side the new ray leaves by. Returns (direction,
    origin, transmission, seed)."""
    absorb = torch.exp(((-dst)[:, None] * m["absorption"][:, :3])
                       * m["absorption_strength"][:, None])
    trans_g = torch.where(
        backface[:, None],
        torch.cat([trans[:, :3] * absorb, torch.ones_like(trans[:, 3:])],
                  dim=1), trans)
    ior = torch.where(backface, m["ior"], 1.0 / m["ior"])
    refract_dir = refract(d, normal, ior[:, None])
    cos_t = torch.clamp(dot(-d, normal), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ior * sin_t > 1.0
    r_refl, seed_refl = rng.rand(seed)
    seed_g = torch.where(cannot, seed, seed_refl)
    follow = cannot | (reflectance(cos_t, ior) > r_refl)
    rand_dir, seed_g = rng.rand_direction(seed_g)
    diffuse = normalize(normal + rand_dir)
    reflect_mix = normalize(lerp(diffuse, reflect(d, normal),
                                 m["specular"][:, None]))
    refract_mix = normalize(lerp(-diffuse, refract_dir,
                                 m["smoothness"][:, None]))
    dir_g = torch.where(follow[:, None], reflect_mix, refract_mix)
    origin_g = point + (1e-4 * normal) * sign(dot(normal, dir_g))[:, None]
    return dir_g, origin_g, trans_g, seed_g


def _nee_sample(t: _Tables, seed, point, normal, trans, color):
    """One light sample from each vertex (reference resolve_and_shade
    :924-1000, in its op order): three draws, the light picked by area (a
    count of the cdf entries the draw reaches), a point on a triangle by the
    sqrt warp, or a direction in the cone a sphere subtends. Returns (seed,
    shadow-ray direction, distance to the light, the contribution if the
    light is unoccluded (rgb), whether the vertex may take the sample)."""
    r_pick, seed = rng.rand(seed)
    r1, seed = rng.rand(seed)
    r2, seed = rng.rand(seed)
    row = t.lights[(r_pick[:, None] >= t.cdf[None, :]).sum(dim=1)]
    is_sph = row[:, 0] > 0.5
    # triangle: cos_l * total_area / (2 pi d^2), single-sided
    su = torch.sqrt(r1)
    p_tri = (row[:, 1:4] * (1.0 - su)[:, None]
             + row[:, 4:7] * (su * (1.0 - r2))[:, None]) \
        + row[:, 7:10] * (su * r2)[:, None]
    dvec = p_tri - point
    d2 = torch.clamp(dot(dvec, dvec), min=_D2_MIN)
    t_tri = torch.sqrt(d2)
    d_tri = dvec / t_tri[:, None]
    cos_l = -dot(row[:, 10:13], d_tri)
    geom_tri = (cos_l * t.c_tri) / d2
    # sphere (radius in v1.x): (1 - cos_max) * total_area / (4 pi r^2)
    rad = row[:, 4]
    cvec = row[:, 1:4] - point
    cd2 = torch.clamp(dot(cvec, cvec), min=_D2_MIN)
    cdist = torch.sqrt(cd2)
    w_ax = cvec / cdist[:, None]
    sin_max = torch.clamp(rad / cdist, 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp(1.0 - sin_max * sin_max, min=0.0))
    cos_t = 1.0 - r1 * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = _TWO_PI * r2
    helper = torch.zeros_like(w_ax)
    helper[:, 0] = torch.where(torch.abs(w_ax[:, 0]) > 0.9, 0.0, 1.0)
    helper[:, 1] = 1.0 - helper[:, 0]
    u_b = normalize(cross(helper, w_ax))
    v_b = cross(w_ax, u_b)
    d_sph = normalize(w_ax * cos_t[:, None]
                      + (u_b * torch.cos(phi)[:, None]
                         + v_b * torch.sin(phi)[:, None]) * sin_t[:, None])
    h_q = dot(d_sph, cvec)
    disc = torch.clamp(h_q * h_q - (cd2 - rad * rad), min=0.0)
    t_sph = h_q - torch.sqrt(disc)
    geom_sph = ((1.0 - cos_max) * t.c_area) \
        / torch.clamp((_FOUR_PI * rad) * rad, min=_D2_MIN)
    # a vertex inside an emissive sphere cannot be cone-sampled
    sph_valid = cdist > rad * _SPH_MARGIN

    d_s = torch.where(is_sph[:, None], d_sph, d_tri)
    geom = torch.where(is_sph, geom_sph, geom_tri)
    contrib = ((trans * color)[:, :3] * row[:, 13:16]) * geom[:, None]
    takes = (dot(normal, d_s) > 0.0) & torch.where(is_sph, sph_valid,
                                                   cos_l > 0.0)
    return (seed, d_s, torch.where(is_sph, t_sph, t_tri), contrib,
            ~is_sph | sph_valid, takes)


def _normal_mapped(t: _Tables, m, kind, normal, surf):
    """The normal a normal map gives a mesh hit (reference resolve_and_shade
    :805-824): the map sampled at the hit's UV, decoded as 2 n - 1, and
    rotated out of the tangent frame — the instance's tangent made
    orthogonal to the normal, the bitangent ``cross(normal, tangent)`` times
    the handedness. Other hits, and materials without a map, keep
    ``normal``."""
    texel = sample_bilinear_quads(t.scene.tex_quads, t.scene.tex_meta,
                                  m["normal_index"].to(torch.int64),
                                  surf["uv"])
    nt = texel[:, :3] * 2.0 - 1.0
    t_w = surf["tangent"]
    t_w = normalize(t_w - normal * dot(t_w, normal, keepdim=True))
    b_w = cross(normal, t_w) * surf["hand"][:, None]
    n_pert = normalize((t_w * nt[:, 0:1] + b_w * nt[:, 1:2])
                       + normal * nt[:, 2:3])
    has = (kind >= 0) & (m["normal_index"] != -1.0)
    t.taps += has.sum()
    return torch.where(has[:, None], n_pert, normal)


def _albedo(t: _Tables, m, hit, surf):
    """The diffuse colour: the texture's sample at the hit's UV where the
    material is textured (flag TEXTURE and a diffuse slot; reference
    resolve_and_shade :869-884), else the material's colour."""
    textured = (m["flag"] == float(MaterialFlag.TEXTURE)) \
        & (m["diffuse_index"] != -1.0)
    t.taps += (textured & hit).sum()
    tex = sample_bilinear_quads(t.scene.tex_quads, t.scene.tex_meta,
                                m["diffuse_index"].to(torch.int64),
                                surf["uv"])
    return torch.where(textured[:, None], tex, m["color"])


def _shade(t: _Tables, o, d, trans, inc, seed, kind, dst, point, normal,
           backface, smat, surf, skybox: bool, sup=None,
           sample: bool = False):
    """resolve_and_shade (megakernel.py:739; ray_tracer.wgsl:398-471): sky
    on a miss, the normal map, the glass or the diffuse/specular branch with
    the textured colour, emission, Russian roulette. Returns the next (o, d,
    trans, incoming, seed, continues) — misses keep their ray — and, with
    next-event estimation (``t.nee``), which lanes sampled a light (their
    next hit adds no emission) and which of them traced a shadow ray;
    otherwise two Nones.

    Next-event estimation: ``sup`` marks the lanes whose last vertex
    sampled a light, whose emission is not added again here; ``sample``
    says the bounce budget leaves room for the sample's direct light. The
    shadow ray is traced here, right after its vertex, whatever the mode:
    mode 2 counts it as a segment (``_render_pixels``), but its hit is the
    same ``_intersect`` call, so both modes give one image, and every lane
    shades in the same batch in both (on the CPU a transcendental can
    round by an ulp differently with an element's place in a batch)."""
    hit = kind != -1
    if skybox:
        inc = torch.where(hit[:, None], inc, inc + trans * environment_light(d))
    m = gather_material(t.scene.mat_rows, smat)
    if t.nmap:
        normal = _normal_mapped(t, m, kind, normal, surf)
    color = _albedo(t, m, hit, surf) if t.tex else m["color"]
    r_spec, seed_n = rng.rand(seed)
    is_spec = m["specular"] >= r_spec
    diffuse, seed_n = rng.rand_hemisphere(normal, seed_n)
    nd = normalize(lerp(diffuse, reflect(d, normal),
                        (m["smoothness"] * is_spec)[:, None]))
    emitted = m["emission_color"] * m["emission_strength"][:, None]
    if t.nee:
        emitted = torch.where(sup[:, None], 0.0, emitted)
    inc_n = inc + emitted * trans
    trans_n = trans * torch.where(is_spec[:, None], m["specular_color"],
                                  color)
    point_n = point
    is_glass = m["flag"] == float(MaterialFlag.GLASS) if t.glass else None
    sampled = shadow = None
    if t.nee:
        seed_n, d_s, t_l, contrib, may, takes = _nee_sample(
            t, seed_n, point, normal, trans, color)
        sampled = hit & ~is_spec & may
        if t.glass:
            sampled = sampled & ~is_glass
        if not sample:
            sampled = torch.zeros_like(sampled)
        shadow = sampled & takes
        lanes = shadow.nonzero()[:, 0]
        occ = torch.full_like(t_l, INF)
        if lanes.numel():
            occ[lanes] = _intersect(t, point[lanes], d_s[lanes])[1]
        ok = shadow & (occ >= t_l * _UNOCC)
        inc_n = inc_n + torch.cat([torch.where(ok[:, None], contrib, 0.0),
                                   torch.zeros_like(inc_n[:, 3:])], dim=1)
    if t.glass:
        g = is_glass[:, None]
        dir_g, origin_g, trans_g, seed_g = _glass(
            m, d, trans, seed, dst, point, normal, backface)
        nd = torch.where(g, dir_g, nd)
        point_n = torch.where(g, origin_g, point)
        trans_n = torch.where(g, trans_g, trans_n)
        inc_n = torch.where(g, inc, inc_n)
        seed_n = torch.where(is_glass, seed_g, seed_n)
    p = trans_n[:, :3].amax(dim=1)
    r_rr, seed_n = rng.rand(seed_n)
    survive = r_rr < p
    trans_n = trans_n / torch.where(p > 0.0, p, t.one)[:, None]
    h = hit[:, None]
    return (torch.where(h, point_n, o), torch.where(h, nd, d),
            torch.where(h, trans_n, trans), torch.where(h, inc_n, inc),
            torch.where(hit, seed_n, seed), hit & survive, sampled, shadow)


def _render_pixels(t: _Tables, pix, frames, *, width, bounces, rpp, skybox,
                   antialias, row_start):
    """Returns (summed light, segments of each pixel)."""
    x = pix % width
    y = row_start + pix // width
    seed = rng.seed_for_pixel(y * width + x, frames)
    acc = torch.zeros((pix.shape[0], 4), dtype=torch.float32, device=t.dev)
    segs = torch.zeros(pix.shape[0], dtype=torch.int64, device=t.dev)
    for _ in range(rpp):
        o, d, seed = _camera_ray(t, x, y, seed, antialias)
        trans = torch.ones_like(acc)
        inc = torch.zeros_like(acc)
        idx = torch.arange(pix.shape[0], device=t.dev)
        # next-event estimation: the lane's last vertex sampled a light
        sup = torch.zeros(pix.shape[0], dtype=torch.bool, device=t.dev)
        for bounce in range(bounces + 1):
            if not idx.numel():
                break
            segs[idx] += 1
            oi, di = o[idx], d[idx]
            hit = _intersect(t, oi, di)
            o[idx], d[idx], trans[idx], inc[idx], seed[idx], cont, sampled, \
                shadow = _shade(t, oi, di, trans[idx], inc[idx], seed[idx],
                                *hit, skybox, sup=sup[idx] if t.nee else None,
                                sample=bounce < bounces)
            if t.nee:
                sup[idx] = sampled
                t.shadow_rays += shadow.sum()
                if t.nee == 2:      # each shadow ray is a segment
                    segs[idx[shadow]] += 1
            idx = idx[cont]
        acc = acc + inc
    return acc, segs


def render_plain(scene: TorchScene, frames: int, *, width: int, height: int,
                 bounces: int, rays_per_pixel: int, skybox: bool,
                 antialias: bool = False, row_start: int = 0,
                 rows: int | None = None, nee: bool = False,
                 nee_segments: bool = False, normal_maps: bool = False,
                 counts: dict | None = None):
    """The plain PyTorch version of ``render_persistent`` (any device).
    Given a dict ``counts``, fills in the traversal's work as the kernel
    counts it (``rows``, ``leaves``, ``boxes``: ints; with next-event
    estimation also ``shadow_rays``; with textures or normal maps
    ``texture_taps``, the texel quads fetched, which the kernel does not
    count) and the segments of each pixel (``pixel_segments``: (rows,
    width) int64)."""
    _require_eligible(scene)
    rows = height if rows is None else rows
    rpp = max(int(rays_per_pixel), 1)
    t = _Tables(scene, width, height, nee_mode(scene, nee, nee_segments),
                normal_maps)
    total = rows * width
    out = torch.empty((total, 4), dtype=torch.float32, device=t.dev)
    pixel_segs = torch.empty(total, dtype=torch.int64, device=t.dev)
    for c0 in range(0, total, PLAIN_CHUNK):
        pix = torch.arange(c0, min(c0 + PLAIN_CHUNK, total), device=t.dev)
        acc, s = _render_pixels(t, pix, frames, width=width, bounces=bounces,
                                rpp=rpp, skybox=skybox, antialias=antialias,
                                row_start=row_start)
        out[c0:c0 + pix.shape[0]] = acc / torch.tensor(
            float(rpp), dtype=torch.float32, device=t.dev)
        pixel_segs[c0:c0 + pix.shape[0]] = s
    if counts is not None:
        counts.update(rows=t.rows, leaves=t.leaves, boxes=int(t.boxes),
                      pixel_segments=pixel_segs.reshape(rows, width))
        if t.nee:
            counts["shadow_rays"] = int(t.shadow_rays)
        if t.tex or t.nmap:
            counts["texture_taps"] = int(t.taps)
    return out.reshape(rows, width, 4), pixel_segs.sum()


# --------------------------------------------------------------------------
# CUDA kernel (csrc/megakernel.cu), built by kernels/cuda_build.py
# --------------------------------------------------------------------------
def kernel_tables(scene: TorchScene, budget: int | None = None) -> dict:
    """The small tables the kernel reads per segment, on the scene's device,
    once per scene (kept in ``scene.derived``): ``scal`` (cam[:3, :4],
    view_params, defocus, diverge), ``spheres`` (one ``SPHERE_COLS`` row per
    sphere, see there), ``inst`` (one ``INST_COLS`` row per instance, see
    there) and ``brute`` (the rows of each distinct brute-force group:
    packed, ``kernels/brute.py:pack_brute_table``, where the kernel stages
    them itself, else staged here once as the kernel would,
    ``kernels/brute.py:stage_brute_rows``). Empty tables hold one zero row.
    The rest picks the kernel's compiled form from what the scene is:

    * ``spheres_mode``: 0 the dense prepass with the exact quadratic, 1 the
      dense prepass with the shared-term formula (from ``SPHERE_FAST_MIN``
      spheres), 2 the sphere BVH;
    * ``staged``: whether spheres, instances and brute-force triangles fit
      ``budget`` (``SMEM_BYTES`` unless given: a measurement gives 0 on a
      scene's first call here to time the other form) and are staged in
      shared memory per block; if not, the kernel reads them from global
      memory. Never for a scene with textures or normal maps: the textured
      forms read their tables from global memory, and so do the other
      forms on such a scene;
    * ``general``: unless the scene is one instance traversed in its wide
      BVH with fewer than ``SPHERE_FAST_MIN`` dense spheres, staged;
    * ``glass``: whether the glass branch is compiled in; off only for such
      a scene, or a general one with modes 0 and ``staged``, without glass.

    The textured forms read the atlas from ``TorchScene.tex_quads``, one
    texel a row of 4 int32 words: a bilinear quad in one 16-byte load."""
    cached = scene.derived.get("megakernel_tables")
    if cached is not None:
        return cached
    dev = scene.device
    ranges = _brute_ranges(scene)
    inst = np.zeros((max(scene.n_instances, 1), INST_COLS), np.float32)
    w2m = scene.inst_world_to_model.cpu().numpy()
    m2w = scene.inst_model_to_world.cpu().numpy()
    for i, (_, tri_off, count) in enumerate(scene.inst_spans):
        brute = count <= BRUTE_MAX_TRIS
        inst[i, 0:12] = w2m[i, :3, :4].reshape(-1)
        inst[i, 12:24] = m2w[i, :3, :4].reshape(-1)
        inst[i, 24:30] = (-1 if brute else scene.wide_roots[i], tri_off,
                          count, scene.inst_mat_deltas[i], float(brute),
                          ranges.get((tri_off, count), 0))
    if np.abs(inst[:, 24:30]).max(initial=0.0) >= 2 ** 24:
        raise ValueError("instance table: an index beyond float32's exact "
                         "integers")
    mode = 2 if scene.sphere_bvh_root >= 0 \
        else int(scene.n_spheres >= SPHERE_FAST_MIN)
    maps = bool({"texture", "normal_map"} & set(scene.shade_classes))
    staged = not maps and smem_bytes(scene) <= (
        SMEM_BYTES if budget is None else budget)
    lean = mode == 0 and staged
    spheres = torch.cat([
        scene.sphere_pos,
        (sphere_k(scene.sphere_pos, scene.sphere_radius) if mode == 1
         else scene.sphere_radius)[:, None],
        scene.sphere_mat.to(torch.float32)[:, None]], dim=1)
    brute = torch.cat([pack_brute_table(scene, *key) for key in ranges]) \
        if ranges else torch.zeros((1, 16), dtype=torch.float32, device=dev)
    tables = dict(
        scal=torch.cat([scene.cam_to_world[:3, :4].reshape(-1),
                        scene.view_params.reshape(-1),
                        scene.defocus_strength.reshape(1),
                        scene.diverge_strength.reshape(1)]).contiguous(),
        spheres=spheres.contiguous() if scene.n_spheres
        else torch.zeros((1, SPHERE_COLS), dtype=torch.float32, device=dev),
        inst=torch.from_numpy(inst).to(dev),
        brute=brute if staged else stage_brute_rows(brute),
        spheres_mode=mode, staged=staged,
        general=not lean or bvh_instances(scene) != [0]
        or scene.n_instances != 1,
        glass=not lean or bool((scene.mat_rows[:, 21]
                                == float(MaterialFlag.GLASS)).any()))
    scene.derived["megakernel_tables"] = tables
    return tables


class CudaMegakernel(CudaKernel):
    """Wrapper of the CUDA kernel: builds ``csrc/megakernel.cu`` at first
    use, checks every tensor it hands over, launches on the current stream
    and counts its launches in ``launches``, those with next-event
    estimation also in ``nee_launches`` (entry point
    ``rt2_render_persistent_nee``, or the textured one) and those of the
    textured forms (entry point ``rt2_render_persistent_tex``) also in
    ``tex_launches``. The kernel itself counts its work on the device
    (``COUNTS``, read with ``read_counts``; the brute-force prepass's with
    ``prepass_counts``)."""

    symbol = "rt2_render_persistent"
    argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 16
                + [ctypes.c_uint32] + [ctypes.c_void_p] * 4)
    nee_symbol = "rt2_render_persistent_nee"
    nee_argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
                    + [ctypes.c_uint32] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p] * 4)
    tex_symbol = "rt2_render_persistent_tex"
    tex_argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                    + [ctypes.c_uint32] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int] + [ctypes.c_void_p] * 4)
    counts = COUNTS

    def __init__(self, source: Path = PKG / "csrc" / "megakernel.cu"):
        super().__init__(source)
        self.nee_launches = 0
        self.tex_launches = 0
        self._nee_fn = self._tex_fn = None

    def _load(self):
        fn = super()._load()
        lib = load_library(self.source, self.build_dir)[0]
        for attr, symbol, argtypes in (
                ("_nee_fn", self.nee_symbol, self.nee_argtypes),
                ("_tex_fn", self.tex_symbol, self.tex_argtypes)):
            entry = getattr(lib, symbol)
            entry.restype = ctypes.c_int
            entry.argtypes = list(argtypes)
            setattr(self, attr, entry)
        return fn

    def reset_counts(self) -> None:
        super().reset_counts()
        self.nee_launches = 0
        self.tex_launches = 0

    def prepass_counts(self) -> tuple[int, int]:
        """What the kernel counted of its brute-force prepass since the last
        ``reset_counts``: (closest-hit calls of the ``csrc/brute.cuh`` loop,
        one per segment and brute-force group, and one per inline shadow
        test and group; launches that made any). Synchronises with the
        device."""
        c = self.read_counts()
        return c["brute_calls"], c["brute_launches"]

    def __call__(self, scene: TorchScene, frames: int, *, width: int,
                 height: int, bounces: int, rays_per_pixel: int,
                 skybox: bool, antialias: bool = False, row_start: int = 0,
                 rows: int | None = None, nee: bool = False,
                 nee_segments: bool = False, normal_maps: bool = False):
        dev = scene.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
        _require_eligible(scene)
        rows = height if rows is None else rows
        tab = kernel_tables(scene)
        n_brute = sum(c for _, c in _brute_ranges(scene))
        check_launch(dev, width=width, height=height, row_start=row_start,
                     rows=rows, wide_rows=(scene.wide_rows, 128),
                     tri_attr=(scene.tri_attr, 128),
                     mat_rows=(scene.mat_rows, 32),
                     spheres=(tab["spheres"], SPHERE_COLS),
                     scal=(tab["scal"], None),
                     inst=(tab["inst"], INST_COLS),
                     brute=(tab["brute"], BRUTE_STAGED))
        if tab["scal"].numel() != 17 or tab["brute"].shape[0] < n_brute \
                or tab["spheres"].shape[0] < scene.n_spheres \
                or not -1 <= scene.sphere_bvh_root < max(
                    scene.wide_rows.shape[0], 1):
            raise ValueError(f"bad tables: {tab['scal'].numel()} camera "
                             f"floats, {tab['brute'].shape[0]} brute rows "
                             f"for {n_brute}, {tab['spheres'].shape[0]} "
                             f"sphere rows for {scene.n_spheres}, sphere "
                             f"root {scene.sphere_bvh_root} of "
                             f"{scene.wide_rows.shape[0]} wide rows")
        check_aligned("wide_rows", scene.wide_rows, 16)
        check_aligned("brute", tab["brute"], 16)
        mode = nee_mode(scene, nee, nee_segments)
        if mode:
            lt = light_tables(scene)
            check_launch(dev, width=width, height=height, row_start=row_start,
                         rows=rows, lights=(lt["rows"], LIGHT_COLS),
                         cdf=(lt["cdf"], None))
        tex = samples_textures(scene, normal_maps)
        if tex:
            texels = scene.tex_quads
            check_launch(dev, width=width, height=height, row_start=row_start,
                         rows=rows, tex_meta=(scene.tex_meta, 4))
            if texels.device != dev or texels.dtype != torch.int32 \
                    or not texels.is_contiguous() or texels.dim() != 2 \
                    or texels.shape[1] != 4 or scene.tex_meta.shape[0] != 64:
                raise ValueError(f"texels: expected contiguous int32 (n, 4) "
                                 f"on {dev}, got {texels.dtype} "
                                 f"{tuple(texels.shape)} on {texels.device}")
            check_aligned("texels", texels, 16)
        fn = self.build()
        out = torch.empty((rows, width, 4), dtype=torch.float32, device=dev)
        scratch = launch_scratch(dev)
        counts = self.device_counts(dev)
        head = (scene.wide_rows.data_ptr(), scene.tri_attr.data_ptr(),
                scene.mat_rows.data_ptr(), tab["spheres"].data_ptr(),
                tab["scal"].data_ptr(), tab["inst"].data_ptr(),
                tab["brute"].data_ptr(), scene.n_spheres, scene.n_instances,
                n_brute, width, height, row_start, rows, bounces,
                max(int(rays_per_pixel), 1), int(bool(skybox)),
                int(bool(antialias)))
        tail = (out.data_ptr(), scratch.data_ptr(), counts.data_ptr())
        form = (tab["spheres_mode"], int(tab["staged"]),
                scene.sphere_bvh_root, frame_seed(frames))
        if tex:
            light = (lt["rows"].data_ptr(), lt["cdf"].data_ptr(),
                     lt["rows"].shape[0], mode, lt["c_tri"], lt["c_area"]) \
                if mode else (None, None, 0, 0, 0.0, 0.0)
            err = launch_on(dev, self._tex_fn, *head, form[0], *form[2:],
                            *light, texels.data_ptr(), texels.shape[0],
                            scene.tex_meta.data_ptr(),
                            int(normal_maps
                                and "normal_map" in scene.shade_classes),
                            *tail)
        elif mode:
            err = launch_on(dev, self._nee_fn, *head, *form,
                            lt["rows"].data_ptr(), lt["cdf"].data_ptr(),
                            lt["rows"].shape[0], mode, lt["c_tri"],
                            lt["c_area"], *tail)
        else:
            err = launch_on(dev, fn, *head, int(tab["general"]),
                            int(tab["glass"]), *form, *tail)
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
        self.launches += 1
        self.nee_launches += bool(mode)
        self.tex_launches += tex
        return out, scratch[0]


#: the process's one handle on the kernel (its ``launches`` count is what
#: chip_smoke.py reads)
CUDA_MEGAKERNEL = CudaMegakernel()
