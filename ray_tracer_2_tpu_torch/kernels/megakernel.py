"""Persistent whole-image render (port of
``ray_tracer_2_tpu/kernels/megakernel.py:render_persistent``, its XLA
boundary and the fused boundary of ``kernels/pallas_boundary.py``).

The scenes it takes: any number of mesh instances (shared tables and
material-id deltas included), each traversed in its wide BVH, or, at
``BRUTE_MAX_TRIS`` triangles or fewer, tested triangle by triangle in the
segment prepass (``kernels/brute.py``); at most ``MAX_SPHERES`` dense
spheres; diffuse, specular, emissive and glass materials. A segment is the
reference's: the dense sphere prepass, each brute-force group in instance
order, then each wide-BVH instance with its pruning limit seeded from the
best world distance so far, every merge on a strict ``<`` of the world
distance; then shading with the hit instance's transform.

Two implementations of one function, chosen by the device the scene's
tensors live on, never by a switch:

* ``render_plain`` — the plain PyTorch version: a wavefront over the
  frame's pixels. A Python loop walks samples and segments; inside it a
  vectorised loop walks the same 32-ary wide rows (accel/wide.py) with a
  per-ray resume stack. It serves CPU tensors, and ``chip_smoke.py`` holds
  the kernel against it on the card.
* ``CUDA_MEGAKERNEL`` — the hand-written CUDA kernel
  (``csrc/megakernel.cu``, its brute-force loop in ``csrc/brute.cuh``),
  one thread per pixel. It serves CUDA tensors; there is no fallback to
  the plain version.

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
from pathlib import Path

import numpy as np
import torch

from ray_tracer_2_tpu_torch.accel.packed import COL_COUNT, COL_FIRST
from ray_tracer_2_tpu_torch.accel.wide import (
    COL_BASE, COL_CHILD_AABB, COL_K, COL_LEAF_GEO, COL_MATCULL, MAX_ARITY,
    N_AABB_COLS,
)
from ray_tracer_2_tpu_torch import rng
from ray_tracer_2_tpu_torch.kernels.brute import (
    BRUTE_MAX_TRIS, brute_force_intersect_plain, pack_brute_table,
)
from ray_tracer_2_tpu_torch.kernels.cuda_build import (
    PKG, CudaKernel, check_launch, frame_seed,
)
from ray_tracer_2_tpu_torch.kernels.intersect import EPS_DET, EPSILON, INF, \
    ray_sphere, sphere_normal
from ray_tracer_2_tpu_torch.kernels.trace import environment_light, \
    gather_material, reflectance
from ray_tracer_2_tpu_torch.math.vec import dot, lerp, normalize, reflect, \
    refract, sign
from ray_tracer_2_tpu_torch.scene.material import MaterialFlag
from ray_tracer_2_tpu_torch.scene.render_scene import SPHERE_BVH_MIN, \
    TorchScene

#: dense prepass capacity (the reference's ``ray_sphere`` prepass; from
#: ``SPHERE_FAST_MIN`` spheres on it takes the shared-term formula)
MAX_SPHERES = 32
#: resume-stack capacity of the CUDA kernel (csrc/megakernel.cu kMaxStack)
MAX_STACK = 16
#: pixels per wavefront of the plain version (bounds its memory)
PLAIN_CHUNK = 1 << 18
#: floats per instance row of the kernel's instance table (csrc/megakernel.cu
#: kInstCols): w2m[:3, :4], m2w[:3, :4], root row, first triangle,
#: triangle count, material-id delta, brute-force flag, brute table row
INST_COLS = 32
#: floats of a brute-force triangle the kernel stages (brute.cuh kStaged)
BRUTE_STAGED = 11
#: shared memory the kernel stages the instance and brute-force tables in
#: (csrc/megakernel.cu kDynSmemBytes): under the 48 KB a block gets
#: without opting in, with its static tables beside it
SMEM_BYTES = 45 * 1024

_F16_MAGIC = 2.0 ** 112          # rebias of f16 exponents onto f32
# absolute and relative slack of the traversal's pruning limit (reference
# megakernel.start_segments): keeps a triangle that ties the prepass hit
_SLACK = float(np.float32(8e-6))
_REL = float(np.float32(1.0 + 4e-6))


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


def smem_bytes(scene: TorchScene) -> int:
    """Shared memory the kernel stages the scene's instance and brute-force
    tables in."""
    n_brute = sum(c for _, c in _brute_ranges(scene))
    return 4 * (scene.n_instances * INST_COLS + n_brute * BRUTE_STAGED)


def ineligibility(scene: TorchScene) -> str | None:
    """Why ``scene`` lies outside the ported megakernel, naming the ROADMAP
    item that lifts it; None if it is inside."""
    if "texture" in scene.shade_classes:
        return "textured materials (ROADMAP Queue 1 item 8)"
    if scene.n_spheres >= SPHERE_BVH_MIN:
        return "the sphere BVH (ROADMAP Queue 1 item 8)"
    if scene.n_spheres > MAX_SPHERES:
        return ("more than 32 spheres, the dense sphere fast path "
                "(ROADMAP Queue 1 item 8)")
    if bvh_instances(scene) and scene.wide_depth + 2 > MAX_STACK:
        return f"wide BVHs deeper than {MAX_STACK - 2} levels"
    if smem_bytes(scene) > SMEM_BYTES:
        return (f"instance and brute-force tables of {smem_bytes(scene)} "
                f"bytes, over the kernel's {SMEM_BYTES}-byte shared-memory "
                "budget (ROADMAP Queue 1 item 4)")
    return None


def _require_eligible(scene: TorchScene) -> None:
    reason = ineligibility(scene)
    if reason is not None:
        raise NotImplementedError(f"not in the ported slice: {reason}")


def render_persistent(scene: TorchScene, frames: int, *, width: int,
                      height: int, bounces: int, rays_per_pixel: int,
                      skybox: bool, antialias: bool = False,
                      row_start: int = 0, rows: int | None = None):
    """Render ``rows`` image rows from ``row_start`` (``width``/``height``
    describe the full image). Returns ``((rows, width, 4) float32 image,
    int64 0-d segment count)`` on the scene's device. CPU scenes take the
    plain version; CUDA scenes take the kernel."""
    kw = dict(width=width, height=height, bounces=bounces,
              rays_per_pixel=rays_per_pixel, skybox=skybox,
              antialias=antialias, row_start=row_start, rows=rows)
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

    def __init__(self, scene: TorchScene, width: int, height: int):
        dev = scene.device
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        self.scene = scene
        self.dev = dev
        self.cam = scene.cam_to_world
        self.view = scene.view_params
        self.bvh = bvh_instances(scene)
        self.brute = brute_instances(scene)
        self.glass = "glass" in scene.shade_classes
        self.depth = scene.wide_depth + 2
        self.w1 = f32(float(max(width - 1, 1)))
        self.h1 = f32(float(max(height - 1, 1)))
        self.inv_w = float(np.float32(1.0) / np.float32(width))
        self.one = f32(1.0)


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


def _traverse(t: _Tables, root, om, dm, limit):
    """Closest hit of model-space rays in the wide BVH whose root row is
    ``root``, pruned at
    ``limit`` (megakernel.py wide_enter + traversal_step): enter the nearest
    hit child, push the other hits as (base, mask, least entry distance),
    pop the deepest entry still closer than the best hit, lowest child
    index first. Returns (dst, u, v, det, tri (-1 = none), mat)."""
    n, dev, depth = om.shape[0], om.device, t.depth
    inv = 1.0 / dm
    best = limit.clone()
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)
    bdet = torch.zeros_like(best)
    tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
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
        if lf.numel():
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
    earlier hit on an equal world distance. Returns (kind: -1 miss / -2
    sphere / >= 0 triangle id, world distance, point, normal, backface,
    material id)."""
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
    if scene.n_spheres:
        s_hit, s_dst, s_in = ray_sphere(o[:, None, :], d[:, None, :],
                                        scene.sphere_pos[None],
                                        scene.sphere_radius[None])
        idx = torch.argmin(s_dst, dim=1, keepdim=True)
        won = s_hit.gather(1, idx)[:, 0]
        sd = s_dst.gather(1, idx)[:, 0]
        inside = s_in.gather(1, idx)[:, 0]
        centre = scene.sphere_pos[idx[:, 0]]
        hp = o + d * sd[:, None]
        kind = torch.where(won, -2, kind)
        seg_dst = torch.where(won, sd, seg_dst)
        point = torch.where(won[:, None], hp, point)
        normal = torch.where(won[:, None], sphere_normal(hp, centre, inside),
                             normal)
        smat = torch.where(won, scene.sphere_mat[idx[:, 0]].to(torch.int64),
                           smat)
        flag = torch.where(won, inside.to(torch.int64), flag)

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

    mesh = kind >= 0
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
    backface = torch.where(kind == -2, flag > 0, det < 0.0)
    return kind, seg_dst, point, normal, backface, smat


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


def _shade(t: _Tables, o, d, trans, inc, seed, kind, dst, point, normal,
           backface, smat, skybox: bool):
    """resolve_and_shade (megakernel.py:739; ray_tracer.wgsl:398-471): sky
    on a miss, the glass or the diffuse/specular branch, emission, Russian
    roulette. Returns the next (o, d, trans, incoming, seed, continues) —
    misses keep their ray."""
    hit = kind != -1
    if skybox:
        inc = torch.where(hit[:, None], inc, inc + trans * environment_light(d))
    m = gather_material(t.scene.mat_rows, smat)
    r_spec, seed_n = rng.rand(seed)
    is_spec = m["specular"] >= r_spec
    diffuse, seed_n = rng.rand_hemisphere(normal, seed_n)
    nd = normalize(lerp(diffuse, reflect(d, normal),
                        (m["smoothness"] * is_spec)[:, None]))
    inc_n = inc + (m["emission_color"] * m["emission_strength"][:, None]) \
        * trans
    trans_n = trans * torch.where(is_spec[:, None], m["specular_color"],
                                  m["color"])
    point_n = point
    if t.glass:
        is_glass = m["flag"] == float(MaterialFlag.GLASS)
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
            torch.where(hit, seed_n, seed), hit & survive)


def _render_pixels(t: _Tables, pix, frames, *, width, bounces, rpp, skybox,
                   antialias, row_start):
    x = pix % width
    y = row_start + pix // width
    seed = rng.seed_for_pixel(y * width + x, frames)
    acc = torch.zeros((pix.shape[0], 4), dtype=torch.float32, device=t.dev)
    segs = 0
    for _ in range(rpp):
        o, d, seed = _camera_ray(t, x, y, seed, antialias)
        trans = torch.ones_like(acc)
        inc = torch.zeros_like(acc)
        idx = torch.arange(pix.shape[0], device=t.dev)
        for _bounce in range(bounces + 1):
            if not idx.numel():
                break
            segs += idx.numel()
            oi, di = o[idx], d[idx]
            hit = _intersect(t, oi, di)
            o[idx], d[idx], trans[idx], inc[idx], seed[idx], cont = _shade(
                t, oi, di, trans[idx], inc[idx], seed[idx], *hit, skybox)
            idx = idx[cont]
        acc = acc + inc
    return acc, segs


def render_plain(scene: TorchScene, frames: int, *, width: int, height: int,
                 bounces: int, rays_per_pixel: int, skybox: bool,
                 antialias: bool = False, row_start: int = 0,
                 rows: int | None = None):
    """The plain PyTorch version of ``render_persistent`` (any device)."""
    _require_eligible(scene)
    rows = height if rows is None else rows
    rpp = max(int(rays_per_pixel), 1)
    t = _Tables(scene, width, height)
    total = rows * width
    out = torch.empty((total, 4), dtype=torch.float32, device=t.dev)
    segs = 0
    for c0 in range(0, total, PLAIN_CHUNK):
        pix = torch.arange(c0, min(c0 + PLAIN_CHUNK, total), device=t.dev)
        acc, s = _render_pixels(t, pix, frames, width=width, bounces=bounces,
                                rpp=rpp, skybox=skybox, antialias=antialias,
                                row_start=row_start)
        out[c0:c0 + pix.shape[0]] = acc / torch.tensor(
            float(rpp), dtype=torch.float32, device=t.dev)
        segs += s
    return (out.reshape(rows, width, 4),
            torch.tensor(segs, dtype=torch.int64, device=t.dev))


# --------------------------------------------------------------------------
# CUDA kernel (csrc/megakernel.cu), built by kernels/cuda_build.py
# --------------------------------------------------------------------------
def kernel_tables(scene: TorchScene) -> dict:
    """The small tables the kernel stages per block, on the scene's device,
    once per scene (kept in ``scene.derived``): ``scal`` (cam[:3, :4],
    view_params, defocus, diverge), ``spheres`` (centre, radius, material
    per row), ``inst`` (one ``INST_COLS`` row per instance, see there) and
    ``brute`` (the packed rows of each distinct brute-force group,
    ``kernels/brute.py:pack_brute_table``). Empty tables hold one zero row.
    ``general`` and ``glass`` pick the kernel's compiled form: ``general``
    unless the scene is one instance traversed in its wide BVH, ``glass``
    if any material is glass."""
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
    spheres = torch.cat([scene.sphere_pos, scene.sphere_radius[:, None],
                         scene.sphere_mat.to(torch.float32)[:, None]], dim=1)
    tables = dict(
        scal=torch.cat([scene.cam_to_world[:3, :4].reshape(-1),
                        scene.view_params.reshape(-1),
                        scene.defocus_strength.reshape(1),
                        scene.diverge_strength.reshape(1)]).contiguous(),
        spheres=spheres.contiguous() if scene.n_spheres
        else torch.zeros((1, 5), dtype=torch.float32, device=dev),
        inst=torch.from_numpy(inst).to(dev),
        brute=torch.cat([pack_brute_table(scene, *key) for key in ranges])
        if ranges else torch.zeros((1, 16), dtype=torch.float32, device=dev),
        general=bvh_instances(scene) != [0] or scene.n_instances != 1,
        glass=bool((scene.mat_rows[:, 21]
                    == float(MaterialFlag.GLASS)).any()))
    scene.derived["megakernel_tables"] = tables
    return tables


class CudaMegakernel(CudaKernel):
    """Wrapper of the CUDA kernel: builds ``csrc/megakernel.cu`` at first
    use, checks every tensor it hands over, launches on the current stream
    and counts its launches in ``launches``. The kernel itself counts its
    brute-force prepass on the device (``prepass_counts``)."""

    symbol = "rt2_render_persistent"
    argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                + [ctypes.c_uint32] + [ctypes.c_void_p] * 4)

    def __init__(self, source: Path = PKG / "csrc" / "megakernel.cu"):
        super().__init__(source)
        self._prepass = {}  # device -> int64 [closest-hit calls, launches]

    def prepass_counts(self) -> tuple[int, int]:
        """What the kernel counted of its brute-force prepass since the last
        ``reset_counts``: (closest-hit calls of the ``csrc/brute.cuh`` loop,
        one per segment and brute-force group; launches that made any).
        Synchronises with the device."""
        calls = launches = 0
        for c in self._prepass.values():
            calls += int(c[0])
            launches += int(c[1])
        return calls, launches

    def reset_counts(self) -> None:
        super().reset_counts()
        for c in self._prepass.values():
            c.zero_()

    def __call__(self, scene: TorchScene, frames: int, *, width: int,
                 height: int, bounces: int, rays_per_pixel: int,
                 skybox: bool, antialias: bool = False, row_start: int = 0,
                 rows: int | None = None):
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
                     spheres=(tab["spheres"], 5), scal=(tab["scal"], None),
                     inst=(tab["inst"], INST_COLS),
                     brute=(tab["brute"], 16))
        if tab["scal"].numel() != 17 or tab["brute"].shape[0] < n_brute:
            raise ValueError(f"bad tables: {tab['scal'].numel()} camera "
                             f"floats, {tab['brute'].shape[0]} brute rows "
                             f"for {n_brute}")
        fn = self.build()
        out = torch.empty((rows, width, 4), dtype=torch.float32, device=dev)
        segments = torch.zeros(1, dtype=torch.int64, device=dev)
        prepass = self._prepass.get(dev)
        if prepass is None:
            prepass = self._prepass[dev] = torch.zeros(
                2, dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(scene.wide_rows.data_ptr(), scene.tri_attr.data_ptr(),
                     scene.mat_rows.data_ptr(), tab["spheres"].data_ptr(),
                     tab["scal"].data_ptr(), tab["inst"].data_ptr(),
                     tab["brute"].data_ptr(), scene.n_spheres,
                     scene.n_instances, n_brute, width, height, row_start,
                     rows, bounces, max(int(rays_per_pixel), 1),
                     int(bool(skybox)), int(bool(antialias)),
                     int(tab["general"]), int(tab["glass"]),
                     frame_seed(frames), out.data_ptr(),
                     segments.data_ptr(), prepass.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
        self.launches += 1
        return out, segments[0]


#: the process's one handle on the kernel (its ``launches`` count is what
#: chip_smoke.py reads)
CUDA_MEGAKERNEL = CudaMegakernel()
