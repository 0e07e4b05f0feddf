"""The port's intersection math against ``ray_tracer_2_tpu.kernels.intersect``.

4096 numpy-made rays against spheres (both sphere formulas, and the dense
prepass's winner under each), triangles (with and without backface cull)
and boxes. Classes: hit masks are equal except on rays within 1e-6
of an edge of the decision (a grazing sphere, a triangle edge, a box
corner), where the two float pipelines may round to either side; distances
of rays both call hits agree within 1e-6 relative. ``math.vec.refract``
(the glass branch's) is held here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu.kernels import intersect as ref
from ray_tracer_2_tpu_torch.kernels import intersect as port
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

B = 4096
EDGE = 1e-6


@pytest.fixture(scope="module")
def rays():
    rs = np.random.default_rng(0)
    o = rs.uniform(-2.0, 2.0, size=(B, 3)).astype(np.float32)
    target = rs.uniform(-0.6, 0.6, size=(B, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _check(hit_ref, hit_port, dst_ref, dst_port, near_edge, rel_tol=1e-6):
    hit_ref, dst_ref = np.asarray(hit_ref), np.asarray(dst_ref)
    hit_port, dst_port = hit_port.numpy(), dst_port.numpy()
    decided = ~near_edge
    assert hit_ref.any() and (~hit_ref).any()      # both outcomes covered
    assert np.array_equal(hit_ref[decided], hit_port[decided])
    both = hit_ref & hit_port
    rel = np.abs(dst_ref[both] - dst_port[both]) / np.abs(dst_ref[both])
    assert rel.max() <= rel_tol
    assert np.all(dst_port[~hit_port] == np.float32(port.INF))


def test_ray_sphere(rays):
    o, d = rays
    rs = np.random.default_rng(1)
    centre = rs.uniform(-0.8, 0.8, size=(6, 3)).astype(np.float32)
    radius = rs.uniform(0.05, 0.6, size=6).astype(np.float32)
    h0, t0, in0 = ref.ray_sphere(jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
                                 jnp.asarray(centre)[None],
                                 jnp.asarray(radius)[None])
    h1, t1, in1 = port.ray_sphere(torch.from_numpy(o)[:, None],
                                  torch.from_numpy(d)[:, None],
                                  torch.from_numpy(centre)[None],
                                  torch.from_numpy(radius)[None])
    # edges: disc ~ 0 (grazing) or the far root ~ the 0.001 cut
    oc = o[:, None] - centre[None]
    b = 2.0 * (oc * d[:, None]).sum(-1)
    c = (oc * oc).sum(-1) - radius ** 2
    disc = b * b - 4.0 * c
    far = (-b + np.sqrt(np.maximum(disc, 0.0))) / 2.0
    near_edge = (np.abs(disc) < EDGE * (b * b + 4 * np.abs(c))) \
        | (np.abs(far - 0.001) < EDGE)
    _check(h0, h1, t0, t1, near_edge)
    both = np.asarray(h0) & h1.numpy()
    assert np.array_equal(np.asarray(in0)[both], in1.numpy()[both])


@pytest.mark.parametrize("cull", [True, False])
def test_ray_triangle(rays, cull):
    o, d = rays
    rs = np.random.default_rng(2)
    v0 = rs.uniform(-1.0, 1.0, size=(8, 3)).astype(np.float32)
    v1 = (v0 + rs.uniform(-0.8, 0.8, size=(8, 3))).astype(np.float32)
    v2 = (v0 + rs.uniform(-0.8, 0.8, size=(8, 3))).astype(np.float32)
    args = (o[:, None], d[:, None], v0[None], v1[None], v2[None])
    h0, t0, u0, w0, det0 = ref.ray_triangle(*map(jnp.asarray, args), cull)
    h1, t1, u1, w1, det1 = port.ray_triangle(
        *map(torch.from_numpy, args), torch.tensor(cull))
    u0, w0, det0 = np.asarray(u0), np.asarray(w0), np.asarray(det0)
    bary = np.minimum(np.minimum(u0, w0), 1.0 - u0 - w0)
    near_edge = (np.abs(bary) < EDGE) | (np.abs(np.asarray(t0) - 1e-5) < EDGE) \
        | (np.abs(np.abs(det0) - 1e-8) < EDGE)
    _check(h0, h1, t0, t1, near_edge)


def test_ray_aabb_dist(rays):
    o, d = rays
    rs = np.random.default_rng(3)
    lo = rs.uniform(-1.0, 0.5, size=(B, 3)).astype(np.float32)
    hi = (lo + rs.uniform(0.05, 1.0, size=(B, 3))).astype(np.float32)
    inv = (1.0 / d).astype(np.float32)
    limit = rs.uniform(0.5, 6.0, size=B).astype(np.float32)
    t0 = np.asarray(ref.ray_aabb_dist(*map(jnp.asarray, (o, inv, lo, hi,
                                                         limit))))
    t1 = port.ray_aabb_dist(*map(torch.from_numpy, (o, inv, lo, hi, limit)))
    t_lo, t_hi = (lo - o) * inv, (hi - o) * inv
    tn = np.minimum(t_lo, t_hi).max(-1)
    tf = np.maximum(t_lo, t_hi).min(-1)
    near_edge = (np.abs(tf - tn) < EDGE) | (np.abs(tn - limit) < EDGE) \
        | (np.abs(tf) < EDGE)
    _check(t0 < np.float32(ref.INF), t1 < port.INF, t0, t1, near_edge)


def test_sphere_normal(rays):
    o, _ = rays
    centre = np.float32([0.1, -0.2, 0.3])
    inside = np.arange(B) % 3 == 0
    n0, _uv = ref.sphere_normal_uv(jnp.asarray(o), jnp.asarray(centre),
                                   jnp.asarray(inside))
    n1 = port.sphere_normal(torch.from_numpy(o), torch.from_numpy(centre),
                            torch.from_numpy(inside))
    assert np.abs(np.asarray(n0) - n1.numpy()).max() <= 1e-6


def test_sphere_uv(rays):
    """Spherical UVs from the (flipped-inside) normal: ``acos`` and
    ``atan2`` of libm against XLA's, and the divisions by 2 pi and pi as
    the products by their float32 reciprocals that XLA compiles them to.
    Within 1e-6 (the UV of one ulp of an angle is 5e-8; measured: at most
    2.4e-7; 93% of u and 82% of v bit-equal)."""
    o, _ = rays
    centre = np.float32([0.1, -0.2, 0.3])
    inside = np.arange(B) % 3 == 0
    n0, uv0 = jax.jit(ref.sphere_normal_uv)(
        jnp.asarray(o), jnp.asarray(centre), jnp.asarray(inside))
    n1, uv1 = port.sphere_normal_uv(torch.from_numpy(o),
                                    torch.from_numpy(centre),
                                    torch.from_numpy(inside))
    uv0, uv1 = np.asarray(uv0), uv1.numpy()
    assert uv1.dtype == np.float32 and uv1.shape == (B, 2)
    assert np.abs(uv0 - uv1).max() <= 1e-6
    assert (uv0 == uv1).mean() >= 0.5
    assert np.abs(np.asarray(n0) - n1.numpy()).max() <= 1e-6


def test_ray_sphere_fast(rays):
    """The shared-term cross (>= SPHERE_FAST_MIN spheres) in the reference's
    op order, with K = |c|^2 - r^2 precomputed as the reference does. The
    reference's dots are ``jnp.sum`` reductions, and the expanded |oc|^2
    cancels, so distances agree within 2e-6 relative (measured: 99.9% of
    hits bit-equal, the worst 1.34e-6)."""
    o, d = rays
    rs = np.random.default_rng(4)
    centre = rs.uniform(-0.8, 0.8, size=(80, 3)).astype(np.float32)
    radius = rs.uniform(0.05, 0.4, size=80).astype(np.float32)
    k = ((centre * centre).sum(-1) - radius * radius).astype(np.float32)
    h0, t0, in0 = ref.ray_sphere_fast(*map(jnp.asarray, (o, d, centre,
                                                         radius, k)))
    h1, t1, in1 = port.ray_sphere_fast(*map(torch.from_numpy,
                                            (o, d, centre, k)))
    h = (o * d).sum(-1)[:, None] - d @ centre.T
    c = (o * o).sum(-1)[:, None] - 2.0 * (o @ centre.T) + k[None]
    disc = h * h - c
    far = -h + np.sqrt(np.maximum(disc, 0.0))
    near_edge = (np.abs(disc) < EDGE * (h * h + np.abs(c))) \
        | (np.abs(far - 0.001) < EDGE)
    _check(h0, h1, t0, t1, near_edge, rel_tol=2e-6)
    both = np.asarray(h0) & h1.numpy()
    assert np.array_equal(np.asarray(in0)[both], in1.numpy()[both])


@pytest.mark.parametrize("n_spheres", [63, 64])
def test_closest_sphere(rays, n_spheres):
    """The dense prepass's winner on both sides of ``SPHERE_FAST_MIN``
    (the exact quadratic below, the shared-term formula from it), against
    the reference's formula of that side with ``argmin``: the same sphere
    and inside flag wherever the reference's two nearest distances differ
    by more than 1e-5 relative, distances within 2e-6 relative. Rays taken
    in blocks of any size give the same records bit for bit."""
    o, d = rays
    rs = np.random.default_rng(n_spheres)
    centre = rs.uniform(-0.8, 0.8, size=(n_spheres, 3)).astype(np.float32)
    radius = rs.uniform(0.05, 0.3, size=n_spheres).astype(np.float32)
    to, td, tc, tr = map(torch.from_numpy, (o, d, centre, radius))
    k = port.sphere_k(tc, tr)
    dst, idx, ins = port.closest_sphere(to, td, tc, tr, k, 1 << 30)
    for elems in (n_spheres, 1000 * n_spheres + 1):
        again = port.closest_sphere(to, td, tc, tr, k, elems)
        assert all(torch.equal(x, y) for x, y in zip((dst, idx, ins), again))
    if n_spheres >= port.SPHERE_FAST_MIN:
        h0, t0, in0 = ref.ray_sphere_fast(*map(jnp.asarray,
                                               (o, d, centre, radius)))
    else:
        h0, t0, in0 = ref.ray_sphere(
            jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
            jnp.asarray(centre)[None], jnp.asarray(radius)[None])
    t0, in0 = np.asarray(t0), np.asarray(in0)
    order = np.sort(t0, axis=1)
    clear = (order[:, 1] - order[:, 0]) > 1e-5 * order[:, 0]
    want = t0.argmin(axis=1)
    hit = t0.min(axis=1) < np.float32(port.INF)
    assert 0.2 < hit.mean() < 1.0 and clear[hit].mean() > 0.99
    sel = clear & hit
    assert np.array_equal(idx.numpy()[sel], want[sel])
    assert np.array_equal(ins.numpy()[sel], in0[np.arange(B), want][sel])
    assert np.array_equal(dst.numpy() < np.float32(port.INF), hit)
    rel = np.abs(dst.numpy()[hit] - t0.min(axis=1)[hit]) / t0.min(axis=1)[hit]
    assert rel.max() <= 2e-6


def test_closest_sphere_keeps_the_lowest_id_on_a_tie():
    """Two copies of one sphere tie exactly: the lower id wins, under both
    formulas."""
    o = torch.tensor([[0.0, 0.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    for n in (5, 70):
        centre = torch.zeros((n, 3))
        centre[:, 0] = torch.arange(n) * 10.0 + 10.0    # out of the way
        centre[n - 1] = centre[2] = torch.tensor([0.0, 0.0, 0.0])
        radius = torch.full((n,), 0.5)
        dst, idx, ins = port.closest_sphere(
            o, d, centre, radius, port.sphere_k(centre, radius), 1 << 20)
        assert int(idx) == 2 and not bool(ins)
        assert abs(float(dst) - 2.5) < 1e-6


@pytest.mark.parametrize("backface", [False, True])
def test_refract(rays, backface):
    """``math.vec.refract`` against the reference's: the zero vector on
    total internal reflection (the same rays, away from the 1e-6 edge of
    the decision), directions within 1e-6 elsewhere."""
    from ray_tracer_2_tpu.math.vec import refract as ref_refract
    from ray_tracer_2_tpu_torch.math.vec import refract
    o, d = rays
    n = o / np.linalg.norm(o, axis=1, keepdims=True)
    if backface:
        n = -n
    eta = np.random.default_rng(1).uniform(0.5, 2.0, B).astype(np.float32)
    want = np.asarray(ref_refract(jnp.asarray(d), jnp.asarray(n),
                                  jnp.asarray(eta)))
    got = refract(torch.from_numpy(d), torch.from_numpy(n),
                  torch.from_numpy(eta)[:, None]).numpy()
    cos = np.sum(n * d, axis=1, dtype=np.float64)
    k = 1.0 - eta.astype(np.float64) ** 2 * (1.0 - cos * cos)
    decided = np.abs(k) > EDGE
    tir = np.all(want == 0.0, axis=1)
    assert tir[decided].any() and (~tir[decided]).any()
    assert np.array_equal(tir[decided], np.all(got == 0.0, axis=1)[decided])
    assert np.abs(want - got)[decided].max() <= 1e-6
