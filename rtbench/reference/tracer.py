"""The plain reference path tracer: the renderer's semantics written out
in PyTorch operations, one batch of (pixel, frame) paths at a time.

What it computes, per path (upstream ray_tracer.wgsl:164-500): a counter
hash RNG seeded with ``pixel + |frame| * 719393``; a camera ray through
the pixel's point on the focus plane (two disk draws for defocus and
divergence); up to ``bounces + 1`` segments, each the closest hit over the
spheres and every instance's triangles (one-sided unless glass, tested in
the instance's model space, merged by world distance in the order spheres,
small instances, large instances, the earlier on a tie); on a miss the sky;
on a hit of glass the reflection or refraction (wgsl:414-436), on any
other hit the diffuse or specular bounce, the texture's bilinear sample
(u8 texels, repeat addressing) and emission; then Russian roulette. It
keeps no acceleration structure of the program: each instance's triangles
sit under a tree of boxes of its own (``scene.box_tree``), walked breadth
first with no pruning, so every triangle whose box the ray crosses is
tested.

Spheres are tested by the exact quadratic, ``b^2 - 4ac`` over ``2a``, in
float32 and in the program's order below 64 spheres. From 64 spheres on
the program's dense test is reassociated (its ``ray_sphere_fast``), so a
ray that grazes a sphere, or leaves one from its surface, may hit it on
one side and miss it on the other there. No order of operations can be
followed then, and the reference solves the quadratic in float64
(``RefScene.sphere_dtype``): in float32, ``|o - c|^2 - r^2`` loses a ray's
origin to rounding on a large sphere, and a ray leaving the ground sphere
of radius 1000 would hit it again.

The float operations follow the renderer's stated precision (float32) and
its order of sums; ``dtype`` lowers it for the control.
"""
from __future__ import annotations

import numpy as np
import torch

from rtbench.reference.scene import FAN, LEAF, RefScene

INF = 1.7014118e38
EPSILON = float(np.float32(1e-5))
EPS_DET = float(np.float32(1e-8))
EPS_SPHERE = float(np.float32(0.001))
_PI = 3.1415926
_M32 = 0xFFFFFFFF
INV_255 = float(np.float32(1.0 / 255.0))

SKY_HORIZON = (1.0, 1.0, 1.0, 0.0)
SKY_ZENITH = (0.0788092, 0.36480793, 0.7264151, 0.0)
GROUND = (0.35, 0.3, 0.35, 0.0)

#: paths traced together, and (ray, box) pairs tested together, on the
#: CPU and on a card
RAY_BLOCK = {"cpu": 1 << 14, "cuda": 1 << 18}
PAIR_BLOCK = {"cpu": 1 << 22, "cuda": 1 << 24}


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _norm(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def _affine(m, v, translate: bool):
    out = torch.stack([(m[r, 0] * v[:, 0] + m[r, 1] * v[:, 1]) + m[r, 2] * v[:, 2]
                       for r in range(3)], dim=1)
    return out + m[:3, 3] if translate else out


class Rng:
    """The per-path u32 stream: an LCG step and a PCG output permutation."""

    def __init__(self, seed: torch.Tensor, dtype):
        self.seed = seed
        self.dtype = dtype

    def u32(self):
        s = (self.seed * 747796405 + 2891336453) & _M32
        self.seed = s
        w = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & _M32
        return (w >> 22) ^ w

    def uniform(self):
        b = self.u32().to(torch.float32)
        d = torch.tensor(4294967295.0, dtype=torch.float32, device=b.device)
        return (b / d).to(self.dtype)

    def normal(self):
        u1, u2 = self.uniform(), self.uniform()
        theta = (2.0 * _PI) * u1
        rho = torch.sqrt(-2.0 * torch.log(torch.clamp(u2, min=2.33e-10)))
        return rho * torch.cos(theta)

    def direction(self):
        x, y, z = self.normal(), self.normal(), self.normal()
        n = torch.sqrt((x * x + y * y) + z * z)
        return torch.stack([x / n, y / n, z / n], dim=-1)

    def disk(self):
        a = (self.uniform() * 2.0) * _PI
        s = torch.sqrt(self.uniform())
        return torch.stack([torch.cos(a) * s, torch.sin(a) * s], dim=-1)

    def where(self, keep, other: "Rng") -> None:
        self.seed = torch.where(keep, self.seed, other.seed)


def environment(d, dtype):
    """The sky: a two-band gradient, the sun, the ground colour below the
    horizon."""
    c = lambda v: torch.tensor(v, dtype=dtype, device=d.device)

    def smooth(e0, e1, x):
        t = torch.clamp((x - e0) / c(e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    y = d[:, 1]
    sky_t = torch.pow(smooth(0.0, 0.4, y), 0.35)
    g2s = smooth(-0.01, 0.0, y)
    hz, zn = c(SKY_HORIZON), c(SKY_ZENITH)
    sky = hz + (zn - hz) * sky_t[:, None]
    cos_sun = (d[:, 0] * 0.1 + d[:, 1] * 1.0) + d[:, 2] * 0.1
    sun = torch.pow(torch.clamp(cos_sun, min=0.0), 500.0) * 0.1
    gr = c(GROUND)
    comp = gr + (sky - gr) * g2s[:, None]
    return comp + (sun * (g2s >= 1.0))[:, None]


def _slab(o, inv, lo, hi):
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tn = torch.minimum(t1, t2).amax(dim=-1)
    tf = torch.maximum(t1, t2).amin(dim=-1)
    return (tf >= tn) & (tf >= 0.0)


def _triangles(geo, om, dm, two=None):
    """The Möller–Trumbore test of rays (n, 3) against their rows of
    ``LEAF`` triangles (n, LEAF, 12), one-sided but where ``two`` (n, LEAF)
    is set: (dst, u, v, det), dst INF where the test fails."""
    v0, e1, e2, nn = geo[..., 0:3], geo[..., 3:6], geo[..., 6:9], geo[..., 9:12]
    o, d = om[:, None, :], dm[:, None, :]
    det = -((d[..., 0] * nn[..., 0] + d[..., 1] * nn[..., 1]) + d[..., 2] * nn[..., 2])
    keep = det >= EPS_DET
    if two is not None:
        keep = torch.where(two, det.abs() >= EPS_DET, keep)
    inv = 1.0 / torch.where(keep, det, torch.ones_like(det))
    ao = o - v0
    dao = torch.stack([ao[..., 1] * d[..., 2] - ao[..., 2] * d[..., 1],
                       ao[..., 2] * d[..., 0] - ao[..., 0] * d[..., 2],
                       ao[..., 0] * d[..., 1] - ao[..., 1] * d[..., 0]], dim=-1)
    dst = _dot(ao, nn) * inv
    u = _dot(e2, dao) * inv
    v = -_dot(e1, dao) * inv
    w = (1.0 - u) - v
    hit = keep & (dst > EPSILON) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    return torch.where(hit, dst, torch.full_like(dst, INF)), u, v, det


def closest_in_instance(inst: dict, om, dm):
    """Closest model-space hit of rays in one instance: (dst (INF on a
    miss), u, v, det, triangle index (-1 on a miss)), by a breadth-first
    walk of its box tree."""
    n, dev, dt = om.shape[0], om.device, om.dtype
    best = torch.full((n,), INF, dtype=dt, device=dev)
    bu, bv, bdet = (torch.zeros_like(best) for _ in range(3))
    btri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    tiny = torch.tensor(1e-20, dtype=dt, device=dev)
    safe = torch.where(dm.abs() < tiny, torch.where(dm < 0, -tiny, tiny), dm)
    inv = 1.0 / safe
    levels = inst["levels"]
    block = PAIR_BLOCK[dev.type]
    # (ray, node) pairs at the root level
    lo, hi = levels[0]
    hit = _slab(om[:, None, :], inv[:, None, :], lo[None], hi[None])
    ray, node = hit.nonzero(as_tuple=True)
    for lo, hi in levels[1:]:
        child = (node[:, None] * FAN + torch.arange(FAN, device=dev)).reshape(-1)
        ray = ray[:, None].expand(-1, FAN).reshape(-1)
        keep = torch.zeros(child.shape[0], dtype=torch.bool, device=dev)
        for s in range(0, child.shape[0], block):
            c, r = child[s:s + block], ray[s:s + block]
            keep[s:s + block] = _slab(om[r], inv[r], lo[c], hi[c])
        ray, node = ray[keep], child[keep]
    # (ray, leaf) pairs: test the leaf's triangles, keep each ray's nearest
    for s in range(0, ray.shape[0], block // LEAF):
        r, leaf = ray[s:s + block // LEAF], node[s:s + block // LEAF]
        two = inst["two_sided"]
        dst, u, v, det = _triangles(inst["geo"][leaf], om[r], dm[r],
                                    None if two is None else two[leaf])
        j = torch.argmin(dst, dim=1, keepdim=True)
        pick = lambda x: x.gather(1, j)[:, 0]
        d1 = pick(dst)
        # nearest over the pairs of a ray: the least distance, then the
        # least triangle index among equal ones
        tri = inst["tri"][leaf * LEAF + j[:, 0]]
        cand = torch.full((n,), INF, dtype=dt, device=dev).scatter_reduce(
            0, r, d1, reduce="amin")
        won = (d1 == cand[r]) & (d1 < best[r])
        big = torch.iinfo(torch.int64).max
        tmin = torch.full((n,), big, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, r[won], tri[won], reduce="amin")
        won &= tri == tmin[r]
        rw = r[won]
        best[rw] = d1[won]
        bu[rw], bv[rw], bdet[rw] = pick(u)[won], pick(v)[won], pick(det)[won]
        btri[rw] = tri[won]
    return best, bu, bv, bdet, btri


def closest_sphere(scene: RefScene, o, d):
    """The nearest sphere of each ray by the exact quadratic, the lowest
    index on a tie: (distance, INF on a miss; sphere index; inside)."""
    st = scene.sphere_dtype
    c = scene.sphere_pos.to(st)[None]
    r = scene.sphere_radius.to(st)[None]
    o_s, d_s = o.to(st), d.to(st)
    oc = o_s[:, None, :] - c
    a = _dot(d_s, d_s)[:, None]
    b = 2.0 * _dot(oc, d_s[:, None, :])
    cc = _dot(oc, oc) - r * r
    disc = b * b - (4.0 * a) * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    near = torch.clamp((-b - sq) / (2.0 * a), min=0.0)
    far = (-b + sq) / (2.0 * a)
    inside = near == 0.0
    ok = (disc >= 0.0) & (far >= EPS_SPHERE)
    sd = torch.where(ok, torch.where(inside, far, near),
                     torch.full_like(far, INF))
    k = torch.argmin(sd, dim=1)
    ar = torch.arange(o.shape[0], device=o.device)
    return sd[ar, k].to(o.dtype), k, inside[ar, k]


def intersect(scene: RefScene, o, d):
    """The segment's closest hit: (hit, world distance, point, shading
    normal, material id, uv, back face)."""
    n, dev, dt = o.shape[0], o.device, o.dtype
    dist = torch.full((n,), INF, dtype=dt, device=dev)
    point = torch.zeros_like(o)
    normal = torch.zeros_like(o)
    mat = torch.zeros(n, dtype=torch.int64, device=dev)
    uv = torch.zeros((n, 2), dtype=dt, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    back = torch.zeros(n, dtype=torch.bool, device=dev)
    if scene.sphere_pos.shape[0]:
        sdk, k, ins = closest_sphere(scene, o, d)
        won = sdk < INF
        hp = o + d * sdk[:, None]
        nv = hp - scene.sphere_pos[k]
        nv = nv / torch.sqrt(_dot(nv, nv))[:, None]
        nv = torch.where(ins[:, None], -nv, nv)
        dist = torch.where(won, sdk, dist)
        point = torch.where(won[:, None], hp, point)
        normal = torch.where(won[:, None], nv, normal)
        mat = torch.where(won, scene.sphere_mat[k], mat)
        back = won & ins
        hit = won
    for inst in scene.instances:
        w2m, m2w = inst["w2m"], inst["m2w"]
        om = _affine(w2m, o, True)
        dm = _norm(_affine(w2m, d, False))
        best, u, v, det, tri = closest_in_instance(inst, om, dm)
        wh = _affine(m2w, om + dm * best[:, None], True)
        wd = torch.sqrt(_dot(wh - o, wh - o))
        won = (tri >= 0) & (wd < dist)
        t = torch.clamp(tri, min=0)
        nr, tuv = inst["nrm"][t], inst["uv"][t]
        wb = (1.0 - u) - v
        sgn = torch.where(det > 0.0, 1.0, torch.where(det < 0.0, -1.0, det))
        nm = _norm((nr[:, 0] * wb[:, None] + nr[:, 1] * u[:, None])
                   + nr[:, 2] * v[:, None]) * sgn[:, None]
        nw = _norm(_affine(m2w, nm, False))
        huv = (tuv[:, 0] * wb[:, None] + tuv[:, 1] * u[:, None]) \
            + tuv[:, 2] * v[:, None]
        dist = torch.where(won, wd, dist)
        point = torch.where(won[:, None], wh, point)
        normal = torch.where(won[:, None], nw, normal)
        mat = torch.where(won, inst["mat"][t], mat)
        uv = torch.where(won[:, None], huv, uv)
        back = torch.where(won, det < 0.0, back)
        hit = hit | won
    return hit, dist, point, normal, mat, uv, back


def sample_texture(img, uv, dtype):
    """Bilinear sample with repeat addressing of a (h, w, 4) u8 image."""
    h, w = img.shape[0], img.shape[1]
    wf = torch.tensor(float(w), dtype=dtype, device=uv.device)
    hf = torch.tensor(float(h), dtype=dtype, device=uv.device)
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    xf = u * wf - 0.5
    yf = v * hf - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    tx = (xf - x0)[:, None]
    ty = (yf - y0)[:, None]
    x0 = torch.remainder(x0.to(torch.int64), w)
    y0 = torch.remainder(y0.to(torch.int64), h)
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    px = lambda yy, xx: img[yy, xx].to(dtype) * INV_255
    top = px(y0, x0) * (1.0 - tx) + px(y0, x1) * tx
    bot = px(y1, x0) * (1.0 - tx) + px(y1, x1) * tx
    return top * (1.0 - ty) + bot * ty


def reflectance(cos_t, ior):
    """Schlick's approximation (wgsl:208-212), ``(1 - cos)^5`` as
    ``x4 * x`` with ``x4 = (x x)(x x)``."""
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    x = 1.0 - cos_t
    x2 = x * x
    x4 = x2 * x2
    return r0 + (1.0 - r0) * (x4 * x)


def glass(scene: RefScene, d, trans, rng: Rng, dist, point, normal, mat,
          back):
    """The glass vertex (wgsl:414-436): Beer–Lambert absorption on a back
    face, Snell's refraction by ``ior`` (back face) or ``1 / ior`` (front
    face) with total internal reflection, a Schlick draw where the ray can
    refract, then a random direction ``dfd = norm(n + g)``: a reflected ray
    ``norm(lerp(dfd, reflect, specular))``, a refracted one
    ``norm(-dfd + (refr + dfd) * smoothness)``, leaving from ``1e-4`` off
    the surface on its side. No emission. Returns the next (origin,
    direction, transmittance); ``rng`` is advanced."""
    b = back[:, None]
    k_abs = scene.mat_absorb_k[mat][:, None]
    absorbed = trans[:, :3] * torch.exp(
        ((-dist)[:, None] * scene.mat_absorb[mat]) * k_abs)
    trans_g = torch.cat([torch.where(b, absorbed, trans[:, :3]),
                         torch.where(b, torch.ones_like(trans[:, 3:]),
                                     trans[:, 3:])], dim=1)
    m_ior = scene.mat_ior[mat]
    ior = torch.where(back, m_ior, 1.0 / m_ior)
    idn = 2.0 * _dot(d, normal)
    cos_i = _dot(normal, d)
    k = 1.0 - (ior * ior) * (1.0 - cos_i * cos_i)
    kr = torch.sqrt(torch.clamp(k, min=0.0))
    cos_t = torch.clamp(_dot(-d, normal), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ior * sin_t > 1.0
    seed = rng.seed
    r_refl = rng.uniform()
    rng.seed = torch.where(cannot, seed, rng.seed)
    follow = cannot | (reflectance(cos_t, ior) > r_refl)
    dfd = _norm(normal + rng.direction())
    refl = d - idn[:, None] * normal
    spec = scene.mat_specular[mat][:, None]
    reflected = dfd + (refl - dfd) * spec
    refr = torch.where((k < 0.0)[:, None], torch.zeros_like(d),
                       ior[:, None] * d - (ior * cos_i + kr)[:, None] * normal)
    a0 = -dfd
    refracted = a0 + (refr - a0) * scene.mat_smooth[mat][:, None]
    nd = _norm(torch.where(follow[:, None], reflected, refracted))
    no = point + (1e-4 * normal) * torch.sign(_dot(normal, nd))[:, None]
    return no, nd, trans_g


def shade(scene: RefScene, o, d, trans, inc, rng: Rng, hit, dist, point,
          normal, mat, uv, back, skybox: bool):
    """One vertex: the sky on a miss; on a hit of glass the glass vertex
    (``glass``), on any other hit the bounce, the albedo (the texture's
    where the material has one) and emission; then Russian roulette.
    Returns the next (o, d, trans, inc) and which paths continue."""
    dt = o.dtype
    if skybox:
        inc = torch.where(hit[:, None], inc, inc + trans * environment(d, dt))
    color = scene.mat_color[mat]
    slot = scene.mat_slot[mat]
    for s, img in enumerate(scene.image_list):
        sel = (slot == s).nonzero()[:, 0]
        if sel.numel():
            color[sel] = sample_texture(img, uv[sel], dt)
    before = Rng(rng.seed, rng.dtype)
    r_spec = rng.uniform()
    spec = scene.mat_specular[mat] >= r_spec
    diffuse = rng.direction()
    s = _dot(normal, diffuse)
    diffuse = torch.where((s >= 0.0)[:, None], diffuse, -diffuse)
    refl = d - (2.0 * _dot(d, normal))[:, None] * normal
    t = (scene.mat_smooth[mat] * spec)[:, None]
    nd = _norm(diffuse + (refl - diffuse) * t)
    inc_n = inc + scene.mat_emit[mat] * trans
    trans_n = trans * torch.where(spec[:, None], scene.mat_spec_color[mat],
                                  color)
    point_n = point
    if scene.has_glass:
        # the glass vertex draws from the same incoming seed
        g_rng = Rng(before.seed, rng.dtype)
        g_o, g_d, g_trans = glass(scene, d, trans, g_rng, dist, point,
                                  normal, mat, back)
        gl = scene.mat_glass[mat]
        gc = gl[:, None]
        point_n = torch.where(gc, g_o, point)
        nd = torch.where(gc, g_d, nd)
        trans_n = torch.where(gc, g_trans, trans_n)
        inc_n = torch.where(gc, inc, inc_n)
        rng.seed = torch.where(gl, g_rng.seed, rng.seed)
    p = trans_n[:, :3].amax(dim=1)
    survive = rng.uniform() < p
    trans_n = trans_n / torch.where(p > 0.0, p, torch.ones_like(p))[:, None]
    rng.where(hit, before)
    h = hit[:, None]
    return (torch.where(h, point_n, o), torch.where(h, nd, d),
            torch.where(h, trans_n, trans), torch.where(h, inc_n, inc),
            hit & survive)


def camera_rays(scene: RefScene, cam: dict, x, y, width: int, height: int,
                rng: Rng):
    """Rays through pixels (x, y) of a ``width`` x ``height`` image."""
    dt, dev = scene.dtype, x.device
    m = torch.as_tensor(cam["cam_to_world"], device=dev).to(dt)
    vp = torch.as_tensor(cam["view"], device=dev).to(dt)
    f = lambda v: torch.tensor(v, dtype=dt, device=dev)
    u0 = x.to(dt) / f(float(max(width - 1, 1)))
    u1 = y.to(dt) / f(float(max(height - 1, 1)))
    lf0 = (u0 - 0.5) * vp[0]
    lf1 = (u1 - 0.5) * vp[1]
    fp = torch.stack([((lf0 * m[r, 0] + lf1 * m[r, 1]) + vp[2] * m[r, 2])
                      + m[r, 3] for r in range(3)], dim=1)
    origin, right, up = m[:3, 3], m[:3, 0], m[:3, 1]
    inv_w = float(np.float32(1.0) / np.float32(width))
    dj = (rng.disk() * f(float(cam["defocus"]))) * inv_w
    o = (origin + right * dj[:, 0:1]) + up * dj[:, 1:2]
    vj = (rng.disk() * f(float(cam["diverge"]))) * inv_w
    fpj = (fp + right * vj[:, 0:1]) + up * vj[:, 1:2]
    return o, _norm(fpj - o)


def trace(scene: RefScene, cam: dict, pixel, frame, *, width: int,
          height: int, bounces: int, skybox: bool = True):
    """Radiance (n, 4) and segments (n,) of the paths of pixel indices
    ``pixel`` (y * width + x) in frames ``frame`` (int64 tensors, one ray a
    pixel)."""
    dev, dt = pixel.device, scene.dtype
    seed = ((pixel & _M32) + (frame.abs() & _M32) * 719393) & _M32
    rng = Rng(seed, dt)
    x, y = pixel % width, pixel // width
    o, d = camera_rays(scene, cam, x, y, width, height, rng)
    n = pixel.shape[0]
    trans = torch.ones((n, 4), dtype=dt, device=dev)
    inc = torch.zeros((n, 4), dtype=dt, device=dev)
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    for _ in range(bounces + 1):
        if not idx.numel():
            break
        segs[idx] += 1
        sub = Rng(rng.seed[idx], dt)
        hit, dist, point, normal, mat, uv, back = intersect(scene, o[idx],
                                                            d[idx])
        o[idx], d[idx], trans[idx], inc[idx], cont = shade(
            scene, o[idx], d[idx], trans[idx], inc[idx], sub, hit, dist,
            point, normal, mat, uv, back, skybox)
        rng.seed[idx] = sub.seed
        idx = idx[cont]
    return inc, segs


def trace_blocks(scene: RefScene, cam: dict, pixel, frame, **kw):
    """``trace`` in blocks of ``RAY_BLOCK`` paths."""
    outs, segs = [], []
    block = RAY_BLOCK[pixel.device.type]
    for s in range(0, pixel.shape[0], block):
        a, b = trace(scene, cam, pixel[s:s + block], frame[s:s + block],
                     **kw)
        outs.append(a)
        segs.append(b)
    return torch.cat(outs), torch.cat(segs)
