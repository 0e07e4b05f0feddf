"""Persistent whole-image render of the main path (port of
``ray_tracer_2_tpu/kernels/megakernel.py:render_persistent`` with the fused
boundary of ``kernels/pallas_boundary.py``).

Two implementations of one function, chosen by the device the scene's
tensors live on, never by a switch:

* ``render_plain`` — the plain PyTorch version: a wavefront over the
  frame's pixels. A Python loop walks samples and segments; inside it a
  vectorised loop walks the same 32-ary wide rows (accel/wide.py) with a
  per-ray resume stack. It serves CPU tensors, and ``chip_smoke.py`` holds
  the kernel against it on the card.
* ``CUDA_MEGAKERNEL`` — the hand-written CUDA kernel
  (``csrc/megakernel.cu``), one thread per pixel. It serves CUDA tensors;
  there is no fallback to the plain version.

Both follow the reference op for op (same RNG stream, same sums in the same
order) so images agree to float rounding; see ``tests/test_torch_megakernel.py``
for the classes they are held to. The TPU scheduling knobs of the reference
(``lanes``, ``unroll``, ``claim``, ``cohorts``, ``boundaries``, ``log_cap``,
``packet``, ``shade_every``, ``fused_boundary``) leave the image unchanged by
construction and have no counterpart here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ray_tracer_2_tpu_torch.accel.packed import COL_COUNT, COL_FIRST
from ray_tracer_2_tpu_torch.accel.wide import (
    COL_BASE, COL_CHILD_AABB, COL_K, COL_LEAF_GEO, COL_MATCULL, MAX_ARITY,
    N_AABB_COLS,
)
from ray_tracer_2_tpu_torch import rng
from ray_tracer_2_tpu_torch.kernels.intersect import EPS_DET, EPSILON, INF, \
    ray_sphere, sphere_normal
from ray_tracer_2_tpu_torch.kernels.trace import environment_light, \
    gather_material
from ray_tracer_2_tpu_torch.math.vec import dot, lerp, normalize, reflect
from ray_tracer_2_tpu_torch.scene.render_scene import TorchScene

#: instance groups at or below this many triangles take the reference's
#: brute-force path (ray_tracer_2_tpu/kernels/brute.py BRUTE_MAX_TRIS)
BRUTE_MAX_TRIS = 256
#: dense prepass capacity of the fused class (pallas_boundary.eligible)
MAX_SPHERES = 32
#: resume-stack capacity of the CUDA kernel (csrc/megakernel.cu kMaxStack)
MAX_STACK = 16
#: pixels per wavefront of the plain version (bounds its memory)
PLAIN_CHUNK = 1 << 18

_F16_MAGIC = 2.0 ** 112          # rebias of f16 exponents onto f32
# absolute and relative slack of the traversal's pruning limit (reference
# megakernel.start_segments): keeps a triangle that ties the prepass hit
_SLACK = float(np.float32(8e-6))
_REL = float(np.float32(1.0 + 4e-6))


def ineligibility(scene: TorchScene) -> str | None:
    """Why ``scene`` lies outside this slice's class (the fused-boundary
    class of the reference, ``pallas_boundary.eligible`` with exactly one
    wide-BVH instance), naming the ROADMAP item that lifts it; None if it is
    inside."""
    if "glass" in scene.shade_classes:
        return "glass materials (ROADMAP Queue 1 item 8)"
    if "texture" in scene.shade_classes:
        return "textured materials (ROADMAP Queue 1 item 8)"
    if scene.n_instances != 1:
        return (f"scenes with {scene.n_instances} mesh instances "
                "(ROADMAP Queue 1 items 7-8)")
    if scene.inst_spans[0][2] <= BRUTE_MAX_TRIS or scene.wide_roots[0] < 0:
        return ("mesh instances of <= 256 triangles, which take the "
                "brute-force path (ROADMAP Queue 1 item 4)")
    if scene.n_spheres > MAX_SPHERES:
        return "more than 32 spheres (ROADMAP Queue 1 item 8)"
    if scene.wide_depth + 2 > MAX_STACK:
        return f"wide BVHs deeper than {MAX_STACK - 2} levels"
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
        self.w2m = scene.inst_world_to_model[0]
        self.m2w = scene.inst_model_to_world[0]
        self.root = scene.wide_rows[scene.wide_roots[0]]
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


def _traverse(t: _Tables, om, dm, limit):
    """Closest hit of model-space rays in the instance's wide BVH, pruned at
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
    descend(all_lanes, t.root.expand(n, -1))
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


def _intersect(t: _Tables, o, d):
    """Segment hit: dense sphere prepass, instance traversal seeded with the
    prepass distance, world-distance merge (megakernel.py segment_prepass,
    start_segments, _advance_impl). Returns (kind: -1 miss / -2 sphere /
    >= 0 triangle id, point, normal, material id)."""
    n, scene = o.shape[0], t.scene
    kind = torch.full((n,), -1, dtype=torch.int64, device=t.dev)
    seg_dst = torch.full((n,), INF, dtype=torch.float32, device=t.dev)
    point = torch.zeros_like(o)
    normal = torch.zeros_like(o)
    smat = torch.zeros(n, dtype=torch.int64, device=t.dev)
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

    om = _affine(t.w2m, o, True)
    dm = normalize(_affine(t.w2m, d, False))
    wv = _affine(t.m2w, dm, False)
    slack = _SLACK * (1.0 + torch.sqrt(dot(o, o)))
    limit = (seg_dst * _REL + slack) / torch.sqrt(dot(wv, wv))
    best, u, v, det, tri, mat = _traverse(t, om, dm, limit)

    wh = _affine(t.m2w, om + dm * best[:, None], True)
    wd = torch.sqrt(dot(wh - o, wh - o))
    mesh = (tri >= 0) & (wd < seg_dst)
    attr = scene.tri_attr[torch.clamp(tri, min=0) >> 2] \
        .view(n, 4, 32)[torch.arange(n, device=t.dev), tri & 3]
    wb = (1.0 - u) - v
    nm = normalize((attr[:, 0:3] * wb[:, None] + attr[:, 3:6] * u[:, None])
                   + attr[:, 6:9] * v[:, None]) * torch.sign(det)[:, None]
    nw = normalize(_affine(t.m2w, nm, False))
    kind = torch.where(mesh, tri, kind)
    point = torch.where(mesh[:, None], wh, point)
    normal = torch.where(mesh[:, None], nw, normal)
    smat = torch.where(mesh, mat, smat)
    return kind, point, normal, smat


def _shade(t: _Tables, o, d, trans, inc, seed, kind, point, normal, smat,
           skybox: bool):
    """resolve_and_shade for the class (megakernel.py:739; the
    diffuse/specular branch, ray_tracer.wgsl:398-471). Returns the next
    (o, d, trans, incoming, seed, continues) — misses keep their ray."""
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
    p = trans_n[:, :3].amax(dim=1)
    r_rr, seed_n = rng.rand(seed_n)
    survive = r_rr < p
    trans_n = trans_n / torch.where(p > 0.0, p, t.one)[:, None]
    h = hit[:, None]
    return (torch.where(h, point, o), torch.where(h, nd, d),
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
            kind, point, normal, smat = _intersect(t, oi, di)
            o[idx], d[idx], trans[idx], inc[idx], seed[idx], cont = _shade(
                t, oi, di, trans[idx], inc[idx], seed[idx], kind, point,
                normal, smat, skybox)
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
# CUDA kernel (csrc/megakernel.cu), built with nvcc and bound with ctypes
# --------------------------------------------------------------------------
_PKG = Path(__file__).resolve().parents[1]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC"]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError("nvcc not found: the CUDA kernel is built on a "
                            "machine with the CUDA toolkit")


class CudaMegakernel:
    """Wrapper of the CUDA kernel: builds ``csrc/megakernel.cu`` into
    ``_build/`` at first use (rebuilding when the source or flags change),
    checks every tensor it hands over, launches on the current stream and
    counts its launches in ``launches``."""

    def __init__(self, source: Path = _PKG / "csrc" / "megakernel.cu",
                 build_dir: Path = _PKG / "_build"):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.launches = 0
        self.build_seconds = 0.0   # nvcc time of this process's build
        self.build_log = ""        # nvcc/ptxas output (registers, spills)
        self._fn = None
        self._lock = threading.Lock()

    def build(self):
        """Compile (if the library for this source is missing) and load."""
        with self._lock:
            if self._fn is None:
                self._fn = self._load()
            return self._fn

    def _load(self):
        src = self.source.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
            .hexdigest()[:16]
        lib = self.build_dir / f"megakernel_{tag}.so"
        if not lib.exists():
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                  str(self.source)],
                                 capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{self.build_log}")
            os.replace(tmp, lib)
        fn = ctypes.CDLL(str(lib)).rt2_render_persistent
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                       + [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p])
        return fn

    def __call__(self, scene: TorchScene, frames: int, *, width: int,
                 height: int, bounces: int, rays_per_pixel: int,
                 skybox: bool, antialias: bool = False, row_start: int = 0,
                 rows: int | None = None):
        dev = scene.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
        _require_eligible(scene)
        rows = height if rows is None else rows
        if rows <= 0 or width <= 0 or row_start < 0 \
                or row_start + rows > height:
            raise ValueError(f"bad image window: rows {rows} from "
                             f"{row_start} of {height}, width {width}")
        fn = self.build()
        w2m, m2w = scene.inst_world_to_model[0], scene.inst_model_to_world[0]
        scal = torch.cat([scene.cam_to_world[:3, :4].reshape(-1),
                          scene.view_params.reshape(-1),
                          scene.defocus_strength.reshape(1),
                          scene.diverge_strength.reshape(1),
                          w2m[:3, :4].reshape(-1), m2w[:3, :4].reshape(-1)])
        spheres = torch.cat([scene.sphere_pos, scene.sphere_radius[:, None],
                             scene.sphere_mat.to(torch.float32)[:, None]],
                            dim=1).contiguous()
        if spheres.shape[0] == 0:
            spheres = torch.zeros((1, 5), dtype=torch.float32, device=dev)
        args = dict(wide_rows=(scene.wide_rows, 128),
                    tri_attr=(scene.tri_attr, 128),
                    mat_rows=(scene.mat_rows, 32), spheres=(spheres, 5),
                    scal=(scal, None))
        for name, (x, cols) in args.items():
            if x.device != dev or x.dtype != torch.float32 \
                    or not x.is_contiguous() \
                    or (cols is not None and (x.dim() != 2
                                              or x.shape[1] != cols)):
                raise ValueError(f"{name}: expected contiguous float32 "
                                 f"(n, {cols}) on {dev}, got {x.dtype} "
                                 f"{tuple(x.shape)} on {x.device}")
        if scal.numel() != 41:
            raise ValueError(f"scal: expected 41 floats, got {scal.numel()}")
        out = torch.empty((rows, width, 4), dtype=torch.float32, device=dev)
        segments = torch.zeros(1, dtype=torch.int64, device=dev)
        frame_seed = ((abs(int(frames)) & 0xFFFFFFFF) * 719393) & 0xFFFFFFFF
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(scene.wide_rows.data_ptr(), scene.tri_attr.data_ptr(),
                     scene.mat_rows.data_ptr(), spheres.data_ptr(),
                     scal.data_ptr(), scene.n_spheres, scene.wide_roots[0],
                     width, height, row_start, rows, bounces,
                     max(int(rays_per_pixel), 1), int(bool(skybox)),
                     int(bool(antialias)), frame_seed, out.data_ptr(),
                     segments.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
        self.launches += 1
        return out, segments[0]


#: the process's one handle on the kernel (its ``launches`` count is what
#: chip_smoke.py reads)
CUDA_MEGAKERNEL = CudaMegakernel()
