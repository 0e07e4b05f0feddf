"""The port's intersection math against ``ray_tracer_2_tpu.kernels.intersect``.

4096 numpy-made rays against spheres, triangles (with and without backface
cull) and boxes. Classes: hit masks are equal except on rays within 1e-6
of an edge of the decision (a grazing sphere, a triangle edge, a box
corner), where the two float pipelines may round to either side; distances
of rays both call hits agree within 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu.kernels import intersect as ref
from ray_tracer_2_tpu_torch.kernels import intersect as port

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


def _check(hit_ref, hit_port, dst_ref, dst_port, near_edge):
    hit_ref, dst_ref = np.asarray(hit_ref), np.asarray(dst_ref)
    hit_port, dst_port = hit_port.numpy(), dst_port.numpy()
    decided = ~near_edge
    assert hit_ref.any() and (~hit_ref).any()      # both outcomes covered
    assert np.array_equal(hit_ref[decided], hit_port[decided])
    both = hit_ref & hit_port
    rel = np.abs(dst_ref[both] - dst_port[both]) / np.abs(dst_ref[both])
    assert rel.max() <= 1e-6
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
