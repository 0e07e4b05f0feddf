"""Whole-path render of small scenes (port of
``ray_tracer_2_tpu/kernels/pallas_spheres.py:render_spheres_pallas``).

Scenes made of spheres plus at most ``MAX_TRIS`` mesh triangles, with no
texture (``balls``, ``metal``, ``random_balls``, ``room``), are traced whole
per pixel: camera ray with defocus and diverge disks, dense closest hit
over every sphere and every world-baked triangle, glass (Beer–Lambert,
Schlick, refraction), diffuse/specular, emission, Russian roulette, and
``rays_per_pixel`` samples. Two implementations of one function, chosen
by the device the scene's tensors live on, never by a switch:

* ``render_spheres_plain`` — the plain PyTorch version: a wavefront over
  the pixels, a Python loop over samples and segments, the dense
  (rays x spheres) and (rays x triangles) crosses in pixel chunks. It
  serves CPU tensors, and ``chip_smoke.py`` holds the kernel against it on
  the card.
* ``CUDA_SPHERES`` — the hand-written CUDA kernel (``csrc/spheres.cu``):
  persistent blocks whose lanes trace one segment per turn and refill from
  a per-launch pixel cursor (``csrc/claim.cuh``), counting the turns and
  active lanes (``COUNTS``). It serves CUDA tensors; there is no fallback.

Both keep the reference kernel's random draws and operation order: the
camera of this kernel (``defocus / width`` as a float32 division, two
disk draws at every sample start), normalisation as ``v * (1 / sqrt(v.v))``,
both shading branches drawing from the same incoming seed, ``jnp.sign``
semantics, and the output ``(acc + inc) * f32(1 / rpp)``. The TPU layout of
the reference (8x128 tiles, one-hot MXU field fetch, 16-bit u32->f32
halves, padded chunks of dummy primitives, the dead-block skip) has no
counterpart: a primitive is a row of a table, a path ends when it ends.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ray_tracer_2_tpu_torch import rng
from ray_tracer_2_tpu_torch.kernels.cuda_build import (
    PKG, CudaKernel, check_launch, frame_seed, launch_on, launch_scratch,
)
from ray_tracer_2_tpu_torch.kernels.intersect import (
    EPS_DET, EPSILON, INF, SPHERE_FAST_MIN, closest_sphere,
)
from ray_tracer_2_tpu_torch.kernels.trace import environment_light, \
    reflectance
from ray_tracer_2_tpu_torch.math.vec import dot, lerp, reflect, sign
from ray_tracer_2_tpu_torch.scene.material import MaterialFlag
from ray_tracer_2_tpu_torch.scene.render_scene import SPHERE_BVH_MIN, \
    TorchScene

#: world-baked triangle cap of the path and of its kernel (reference
#: ``MAX_TRIS``, chosen there by a TPU measurement; what the H100 measured
#: at the cap is in PERF.md, section 6)
MAX_TRIS = 64
#: spheres the kernel stages in shared memory (scenes at SPHERE_BVH_MIN
#: and above take the sphere BVH in the reference)
MAX_SPHERES = SPHERE_BVH_MIN - 1
#: columns of the per-primitive field table: 0:32 the material row
#: (scene/render_scene.py ``_pack_material_rows``), 32:35 a sphere's
#: centre, 35 its radius, 36:45 a triangle's world vertex normals n0 n1 n2
F_CENTRE = 32
F_N0 = 36
N_FIELDS = 48
#: the kernel's device counts, in csrc/spheres.cu's order (kCnt*): turns
#: of a warp's lane loop, lanes holding a path summed over those turns
COUNTS = ("turns", "active_lanes")
#: elements of one (rays x spheres) float32 temporary of the plain
#: version (256 MB); its pixel chunks are sized by it
PLAIN_ELEMS = 1 << 26


def tri_count(scene: TorchScene) -> int:
    return sum(c for _, _, c in scene.inst_spans)


def eligible(scene: TorchScene) -> bool:
    """The reference's ``pallas_spheres.eligible``: something to render, at
    most ``MAX_TRIS`` triangles, no textured material (flag and diffuse
    texture index read from ``mat_rows`` columns 21-22)."""
    n_tris = tri_count(scene)
    if n_tris > MAX_TRIS or scene.n_spheres > MAX_SPHERES:
        return False
    if n_tris == 0 and scene.n_spheres == 0:
        return False
    rows = scene.mat_rows.cpu()
    return bool((rows[:, 21] != int(MaterialFlag.TEXTURE)).all()
                and (rows[:, 22] < 0).all())


def _require_eligible(scene: TorchScene) -> None:
    if not eligible(scene):
        raise NotImplementedError(
            "not a small scene (spheres plus <= 64 untextured triangles): "
            "render it through the megakernel (render_persistent), which "
            "takes textured scenes too, as in the reference")


@dataclasses.dataclass(frozen=True)
class SmallTables:
    """The scene as the small-scene path reads it, on the scene's device."""

    spheres: torch.Tensor   # (S, 8) f32: centre, radius, K = |c|^2 - r^2
    tris: torch.Tensor      # (T, 16) f32: world v0, e1, e2, gn = e1 x e2,
                            # cull (1 unless glass)
    fields: torch.Tensor    # (S + T, 48) f32, see F_CENTRE / F_N0

    @property
    def n_spheres(self) -> int:
        return int(self.spheres.shape[0])

    @property
    def n_tris(self) -> int:
        return int(self.tris.shape[0])


def _rows_times(v, m):
    """``v @ m.T`` for (n, 3) rows as ``(v0 m_0 + v1 m_1) + v2 m_2``."""
    return (v[:, 0:1] * m[:, 0] + v[:, 1:2] * m[:, 1]) + v[:, 2:3] * m[:, 2]


def pack_tables(scene: TorchScene) -> SmallTables:
    """Host packing of the reference's ``_pack_tables``, once per scene (kept
    in ``scene.derived``). Triangles are baked to world space: ``v R^T + t``,
    with v1/v2 and n1/n2 swapped under a reflecting transform so winding,
    backface and cull keep their model-space meaning."""
    cached = scene.derived.get("small_tables")
    if cached is not None:
        return cached
    host = lambda t: t.detach().cpu().numpy()
    f32 = np.float32
    pos, rad = host(scene.sphere_pos), host(scene.sphere_radius)
    mat_rows = host(scene.mat_rows)
    S = len(pos)
    sph = np.zeros((S, 8), f32)
    sph[:, 0:3] = pos
    sph[:, 3] = rad
    sph[:, 4] = ((pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1])
                 + pos[:, 2] * pos[:, 2]) - rad * rad

    keys = ("v0", "v1", "v2", "n0", "n1", "n2", "mat")
    model = {k: host(getattr(scene, f"tri_{k}")) for k in keys}
    world = {k: [] for k in keys}
    for i, (_n, toff, cnt) in enumerate(scene.inst_spans):
        if cnt == 0:
            continue
        m2w = host(scene.inst_model_to_world[i])
        R, t = m2w[:3, :3], m2w[:3, 3]
        det = (R[0, 0] * (R[1, 1] * R[2, 2] - R[1, 2] * R[2, 1])
               - R[0, 1] * (R[1, 0] * R[2, 2] - R[1, 2] * R[2, 0])
               + R[0, 2] * (R[1, 0] * R[2, 1] - R[1, 1] * R[2, 0]))
        part = {k: model[k][toff:toff + cnt] for k in keys}
        v = [_rows_times(part[k], R) + t for k in ("v0", "v1", "v2")]
        n = [_rows_times(part[k], R) for k in ("n0", "n1", "n2")]
        if det < 0.0:
            v[1], v[2], n[1], n[2] = v[2], v[1], n[2], n[1]
        for k, a in zip(keys, v + n + [part["mat"]
                                       + scene.inst_mat_deltas[i]]):
            world[k].append(a)
    T = sum(len(m) for m in world["mat"])
    tri = np.zeros((T, 16), f32)
    fields = np.zeros((S + T, N_FIELDS), f32)
    if S:
        fields[:S, :32] = mat_rows[host(scene.sphere_mat)]
        fields[:S, F_CENTRE:F_CENTRE + 3] = pos
        fields[:S, F_CENTRE + 3] = rad
    if T:
        w = {k: np.concatenate(a) for k, a in world.items()}
        e1, e2 = w["v1"] - w["v0"], w["v2"] - w["v0"]
        gn = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                       e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                       e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
        tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], tri[:, 9:12] = \
            w["v0"], e1, e2, gn
        tri[:, 12] = mat_rows[w["mat"], 21] != MaterialFlag.GLASS
        fields[S:, :32] = mat_rows[w["mat"]]
        fields[S:, F_N0:F_N0 + 9] = np.concatenate(
            [w["n0"], w["n1"], w["n2"]], axis=1)
    dev = scene.device
    tables = SmallTables(*(torch.from_numpy(a).to(dev)
                           for a in (sph, tri, fields)))
    scene.derived["small_tables"] = tables
    return tables


def camera_vector(scene: TorchScene, width: int, height: int):
    """The 18 camera floats of the reference kernel (``render_spheres_pallas``
    ``cam_c``): ``cam[:3, :3]`` row-major, its origin, ``view_params``,
    ``defocus / width`` and ``diverge / width`` (float32 divisions) and the
    image height."""
    dev = scene.device
    w = torch.tensor(float(width), dtype=torch.float32, device=dev)
    cam = scene.cam_to_world
    return torch.cat([cam[:3, :3].reshape(-1), cam[:3, 3],
                      scene.view_params.reshape(-1),
                      (scene.defocus_strength / w).reshape(1),
                      (scene.diverge_strength / w).reshape(1),
                      torch.tensor([float(height)], dtype=torch.float32,
                                   device=dev)])


def render_spheres(scene: TorchScene, frames: int, *, width: int,
                   height: int, bounces: int, rays_per_pixel: int,
                   skybox: bool, row_start: int = 0,
                   rows: int | None = None):
    """Render ``rows`` image rows from ``row_start`` (``width``/``height``
    describe the full image). Returns ``((rows, width, 4) float32 image,
    int64 0-d segment count)`` on the scene's device. CPU scenes take the
    plain version; CUDA scenes take the kernel."""
    kw = dict(width=width, height=height, bounces=bounces,
              rays_per_pixel=rays_per_pixel, skybox=skybox,
              row_start=row_start, rows=rows)
    if scene.device.type == "cpu":
        return render_spheres_plain(scene, frames, **kw)
    if scene.device.type == "cuda":
        return CUDA_SPHERES(scene, frames, **kw)
    raise ValueError(f"no implementation for device {scene.device}")


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def _norm3(v):
    """The reference kernel's ``_norm3``: ``v * (1 / sqrt(v.v))``."""
    return v * torch.reciprocal(torch.sqrt(dot(v, v, keepdim=True)))


def _rand_direction(seed):
    """Three normal draws in (x, y, z) order, normalised by ``_norm3``."""
    x, seed = rng.rand_normal(seed)
    y, seed = rng.rand_normal(seed)
    z, seed = rng.rand_normal(seed)
    return _norm3(torch.stack([x, y, z], dim=-1)), seed


def _closest_tri(tab: SmallTables, o, d):
    """Nearest world-baked triangle (Möller–Trumbore with the precomputed
    geometric normal, reference ``tri_pass``), lowest id on equal distance.
    Returns (dst (INF on a miss), id, u, v, det)."""
    tri = tab.tris[None]
    v0, e1, e2, gn = (tri[..., 3 * k:3 * k + 3] for k in range(4))
    cull = tri[..., 12] > 0.5
    o, d = o[:, None, :], d[:, None, :]
    det = -dot(d, gn)
    keep = torch.where(cull, det >= EPS_DET, torch.abs(det) >= EPS_DET)
    inv = 1.0 / torch.where(keep, det, torch.ones_like(det))
    ao = o - v0
    aox, aoy, aoz = ao[..., 0], ao[..., 1], ao[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    dao = torch.stack([aoy * dz - aoz * dy, aoz * dx - aox * dz,
                       aox * dy - aoy * dx], dim=-1)
    dst = dot(ao, gn) * inv
    u = dot(e2, dao) * inv
    v = -dot(e1, dao) * inv
    w = (1.0 - u) - v
    hit = keep & (dst > EPSILON) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    dstw = torch.where(hit, dst, torch.full_like(dst, INF))
    idx = torch.argmin(dstw, dim=1, keepdim=True)
    pick = lambda x: x.gather(1, idx)[:, 0]
    return pick(dstw), idx[:, 0], pick(u), pick(v), pick(det)


def _segment(tab: SmallTables, o, d, tr, inc, seed, *, skybox: bool):
    """One segment of live paths (the reference kernel's ``body`` after
    the restart): closest hit, sky on a miss, the glass or the
    diffuse/specular branch, Russian roulette. Returns the next
    (o, d, tr, inc, seed, continues)."""
    n, dev = o.shape[0], o.device
    S, T = tab.n_spheres, tab.n_tris
    if S:
        sph = tab.spheres
        sd, sid, sins = closest_sphere(o, d, sph[:, 0:3], sph[:, 3],
                                       sph[:, 4], PLAIN_ELEMS)
    else:
        sd = torch.full((n,), INF, dtype=torch.float32, device=dev)
        sid = torch.zeros(n, dtype=torch.int64, device=dev)
        sins = torch.zeros(n, dtype=torch.bool, device=dev)
    if T:
        td, tid, tu, tv, tdet = _closest_tri(tab, o, d)
    else:
        td = torch.full_like(sd, INF)
        tid = torch.zeros_like(sid)
        tu = tv = tdet = torch.zeros_like(sd)
    tri_win = td < sd                      # equal distance: the sphere
    dist = torch.minimum(sd, td)
    hit = dist < INF
    F = tab.fields[torch.where(tri_win, S + tid, sid)]
    backface = torch.where(tri_win, tdet < 0.0, sins)
    h = o + d * dist[:, None]

    if S:
        nrm = _norm3(h - F[:, F_CENTRE:F_CENTRE + 3])
        nrm = nrm * torch.where(backface, -1.0, 1.0)[:, None]
    else:
        nrm = torch.zeros_like(o)
    if T:
        wb = ((1.0 - tu) - tv)[:, None]
        sgn = torch.where(tdet < 0.0, -1.0, 1.0)[:, None]
        tn = (F[:, F_N0:F_N0 + 3] * wb + F[:, F_N0 + 3:F_N0 + 6] * tu[:, None]) \
            + F[:, F_N0 + 6:F_N0 + 9] * tv[:, None]
        nrm = torch.where(tri_win[:, None], _norm3(tn * sgn), nrm)

    if skybox:
        inc = torch.where(hit[:, None], inc, inc + tr * environment_light(d))

    m_color, m_emis, m_spec_c = F[:, 0:4], F[:, 4:8], F[:, 8:12]
    m_abs, m_abs_k, m_emis_k = F[:, 12:15], F[:, 16:17], F[:, 17:18]
    m_smooth, m_spec = F[:, 18:19], F[:, 19]
    m_ior = torch.where(hit, F[:, 20], 1.0)
    is_glass = F[:, 21] == float(MaterialFlag.GLASS)
    ddn = dot(d, nrm)
    rf = reflect(d, nrm)

    # ---- glass (ray_tracer.wgsl:414-436)
    gb = backface[:, None]
    tr_g = torch.cat([torch.where(gb, tr[:, :3] * torch.exp(
        ((-dist)[:, None] * m_abs) * m_abs_k), tr[:, :3]),
        torch.where(gb, 1.0, tr[:, 3:4])], dim=1)
    ior = torch.where(backface, m_ior, 1.0 / m_ior)
    kk = 1.0 - (ior * ior) * (1.0 - ddn * ddn)
    kr = torch.sqrt(torch.clamp(kk, min=0.0))
    rr = torch.where((kk >= 0.0)[:, None], ior[:, None] * d
                     - (ior * ddn + kr)[:, None] * nrm, 0.0)
    cos_t = torch.clamp(-ddn, max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ior * sin_t > 1.0
    r_refl, seed_refl = rng.rand(seed)
    seed_g = torch.where(cannot, seed, seed_refl)
    follow = cannot | (reflectance(cos_t, ior) > r_refl)
    g, seed_g = _rand_direction(seed_g)
    dfd = _norm3(nrm + g)
    gd = torch.where(follow[:, None], _norm3(lerp(dfd, rf, m_spec[:, None])),
                     _norm3(-dfd + (rr + dfd) * m_smooth))
    go = h + (1e-4 * nrm) * sign(dot(nrm, gd))[:, None]

    # ---- diffuse / specular (ray_tracer.wgsl:437-459)
    r_spec, seed_n = rng.rand(seed)
    is_spec = m_spec >= r_spec
    u, seed_n = _rand_direction(seed_n)
    hemi = sign(dot(nrm, u))
    hd = u * torch.where(hemi == 0.0, 1.0, hemi)[:, None]
    nd = _norm3(lerp(hd, rf, m_smooth * is_spec[:, None]))
    inc_n = inc + (m_emis * m_emis_k) * tr
    tr_n = tr * torch.where(is_spec[:, None], m_spec_c, m_color)

    # ---- the taken branch, Russian roulette
    glass = is_glass[:, None]
    nd = torch.where(glass, gd, nd)
    no = torch.where(glass, go, h)
    ntr = torch.where(glass, tr_g, tr_n)
    inc = torch.where((is_glass | ~hit)[:, None], inc, inc_n)
    nseed = torch.where(is_glass, seed_g, seed_n)
    p = torch.maximum(ntr[:, 0], torch.maximum(ntr[:, 1], ntr[:, 2]))
    r_rr, nseed = rng.rand(nseed)
    ntr = ntr / torch.where(p > 0.0, p, 1.0)[:, None]
    h1 = hit[:, None]
    return (torch.where(h1, no, o), torch.where(h1, nd, d),
            torch.where(h1, ntr, tr), inc, torch.where(hit, nseed, seed),
            hit & (r_rr < p))


def _render_chunk(tab: SmallTables, cam, pix, frames, *, width, bounces,
                  rpp, skybox, row_start):
    dev = pix.device
    xi = pix % width
    yi = row_start + pix // width
    seed = rng.seed_for_pixel(yi * width + xi, frames)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    w1 = torch.maximum(torch.tensor(float(width), dtype=torch.float32,
                                    device=dev) - 1.0, one)
    h1 = torch.maximum(cam[17] - 1.0, one)
    R, c, vp = cam[0:9].reshape(3, 3), cam[9:12], cam[12:15]
    defocus, diverge = cam[15], cam[16]
    lfx = (xi.to(torch.float32) / w1 - 0.5) * vp[0]
    lfy = (yi.to(torch.float32) / h1 - 0.5) * vp[1]
    f = torch.stack([((R[r, 0] * lfx + R[r, 1] * lfy) + R[r, 2] * vp[2])
                     + c[r] for r in range(3)], dim=1)
    n = pix.shape[0]
    acc = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    inc = torch.zeros_like(acc)
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(rpp):
        # sample start (wgsl:487-497): defocus disk, then diverge disk
        dj, seed = rng.rand_in_unit_disk(seed)
        jx, jy = dj[:, 0] * defocus, dj[:, 1] * defocus
        o = torch.stack([(c[r] + R[r, 0] * jx) + R[r, 1] * jy
                         for r in range(3)], dim=1)
        vj, seed = rng.rand_in_unit_disk(seed)
        vx, vy = vj[:, 0] * diverge, vj[:, 1] * diverge
        fj = torch.stack([(f[:, r] + R[r, 0] * vx) + R[r, 1] * vy
                          for r in range(3)], dim=1)
        d = _norm3(fj - o)
        acc = acc + inc
        inc = torch.zeros_like(acc)
        tr = torch.ones_like(acc)
        idx = torch.arange(n, device=dev)
        for _bounce in range(bounces + 1):
            if not idx.numel():
                break
            segs[idx] += 1
            o[idx], d[idx], tr[idx], inc[idx], seed[idx], cont = _segment(
                tab, o[idx], d[idx], tr[idx], inc[idx], seed[idx],
                skybox=skybox)
            idx = idx[cont]
    return acc + inc, segs


def render_spheres_plain(scene: TorchScene, frames: int, *, width: int,
                         height: int, bounces: int, rays_per_pixel: int,
                         skybox: bool, row_start: int = 0,
                         rows: int | None = None,
                         counts: dict | None = None):
    """The plain PyTorch version of ``render_spheres`` (any device). Given a
    dict ``counts``, fills in the segments of each pixel
    (``pixel_segments``: (rows, width) int64)."""
    _require_eligible(scene)
    rows = height if rows is None else rows
    rpp = max(int(rays_per_pixel), 1)
    tab = pack_tables(scene)
    cam = camera_vector(scene, width, height)
    dev = scene.device
    total = rows * width
    chunk = max(PLAIN_ELEMS // max(tab.n_spheres, tab.n_tris, 1), 1)
    inv_rpp = torch.tensor(float(np.float32(1.0 / rpp)), dtype=torch.float32,
                           device=dev)
    out = torch.empty((total, 4), dtype=torch.float32, device=dev)
    pixel_segs = torch.empty(total, dtype=torch.int64, device=dev)
    for c0 in range(0, total, chunk):
        pix = torch.arange(c0, min(c0 + chunk, total), device=dev)
        acc, s = _render_chunk(tab, cam, pix, frames, width=width,
                               bounces=bounces, rpp=rpp, skybox=skybox,
                               row_start=row_start)
        out[c0:c0 + pix.shape[0]] = acc * inv_rpp
        pixel_segs[c0:c0 + pix.shape[0]] = s
    if counts is not None:
        counts.update(pixel_segments=pixel_segs.reshape(rows, width))
    return out.reshape(rows, width, 4), pixel_segs.sum()


# --------------------------------------------------------------------------
# CUDA kernel (csrc/spheres.cu), built by kernels/cuda_build.py
# --------------------------------------------------------------------------
class CudaSpheres(CudaKernel):
    """Wrapper of the small-scene CUDA kernel: builds ``csrc/spheres.cu`` at
    first use, checks every tensor it hands over, launches on the current
    stream and counts its launches in ``launches``; the kernel counts its
    lane loop on the device (``COUNTS``, read with ``read_counts``)."""

    symbol = "rt2_render_spheres"
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                + [ctypes.c_uint32, ctypes.c_float] + [ctypes.c_void_p] * 4)
    counts = COUNTS

    def __init__(self, source: Path = PKG / "csrc" / "spheres.cu"):
        super().__init__(source)

    def __call__(self, scene: TorchScene, frames: int, *, width: int,
                 height: int, bounces: int, rays_per_pixel: int,
                 skybox: bool, row_start: int = 0, rows: int | None = None):
        dev = scene.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, not {dev}")
        _require_eligible(scene)
        rows = height if rows is None else rows
        tab = pack_tables(scene)
        cam = camera_vector(scene, width, height)
        S, T = tab.n_spheres, tab.n_tris
        check_launch(dev, width=width, height=height, row_start=row_start,
                     rows=rows, spheres=(tab.spheres, 8),
                     tris=(tab.tris, 16), fields=(tab.fields, N_FIELDS),
                     cam=(cam, None))
        if cam.numel() != 18 or tab.fields.shape[0] != S + T \
                or S > MAX_SPHERES or T > MAX_TRIS:
            raise ValueError(f"bad tables: {S} spheres, {T} triangles, "
                             f"{tab.fields.shape[0]} field rows, "
                             f"{cam.numel()} camera floats")
        fn = self.build()
        rpp = max(int(rays_per_pixel), 1)
        out = torch.empty((rows, width, 4), dtype=torch.float32, device=dev)
        scratch = launch_scratch(dev)
        counts = self.device_counts(dev)
        err = launch_on(
            dev, fn, tab.spheres.data_ptr(), tab.tris.data_ptr(),
            tab.fields.data_ptr(), cam.data_ptr(), S, T,
            int(S >= SPHERE_FAST_MIN), width, row_start, rows, bounces, rpp,
            int(bool(skybox)), frame_seed(frames),
            float(np.float32(1.0 / rpp)), out.data_ptr(),
            scratch.data_ptr(), counts.data_ptr())
        if err != 0:
            raise RuntimeError(f"spheres kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out, scratch[0]


#: the process's one handle on the kernel (its ``launches`` count is what
#: chip_smoke.py reads)
CUDA_SPHERES = CudaSpheres()
