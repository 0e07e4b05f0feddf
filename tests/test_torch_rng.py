"""The port's counter-hash RNG against ``ray_tracer_2_tpu.rng`` over 1M seeds.

Classes: seeds, raw bits and ``rand`` are bit-exact (integer arithmetic and
one correctly rounded u32 -> f32 convert). The transcendental draws agree
within 4 ulp: XLA's CPU log/cos/sin are not the libm PyTorch calls, and
``rand_direction``'s normalisation adds its own rounding, so a direction is
held to 4 ulp of its largest component.

PyTorch runs on one thread here: with JAX's CPU runtime in the same
process, its multi-threaded ``log`` was seen to return a value 1e-4 off for
a single element of the million in some runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu import rng as ref
from ray_tracer_2_tpu_torch import rng

N = 1 << 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def seeds():
    s = np.random.default_rng(0).integers(0, 2 ** 32, size=N,
                                          dtype=np.uint64).astype(np.uint32)
    return jnp.asarray(s), torch.from_numpy(s.astype(np.int64))


def _same_seed(js, ts):
    return np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())


def _ulps(a, b, scale=None):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if scale is None:
        scale = np.maximum(np.abs(a), np.abs(b))
    return np.abs(a.astype(np.float64) - b) / np.spacing(scale)


@pytest.mark.parametrize("frames", [-3, 0, 1, 7, 100_000])
def test_seed_for_pixel_exact(frames):
    px = np.random.default_rng(1).integers(0, 2 ** 31, size=4096)
    a = ref.seed_for_pixel(jnp.asarray(px, jnp.int32), frames)
    b = rng.seed_for_pixel(torch.from_numpy(px), frames)
    assert _same_seed(a, b)


def test_next_u32_and_rand_exact(seeds):
    js, ts = seeds
    jb, jn = ref.next_u32(js)
    tb, tn = rng.next_u32(ts)
    assert _same_seed(jb, tb) and _same_seed(jn, tn)
    jv, jn = ref.rand(js)
    tv, tn = rng.rand(ts)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert _same_seed(jn, tn)
    assert tv.dtype == torch.float32 and 0.0 <= float(tv.min()) \
        and float(tv.max()) <= 1.0


@pytest.mark.parametrize("name", ["rand_normal", "rand_in_unit_disk"])
def test_scalar_draws_within_4_ulp(seeds, name):
    js, ts = seeds
    jv, jn = getattr(ref, name)(js)
    tv, tn = getattr(rng, name)(ts)
    assert _same_seed(jn, tn)
    u = _ulps(jv, tv.numpy())
    assert u.max() <= 4.0, (u.max(), np.asarray(jv).ravel()[u.argmax()])


def test_directions_within_4_ulp(seeds):
    js, ts = seeds
    jv, jn = ref.rand_direction(js)
    tv, tn = rng.rand_direction(ts)
    assert _same_seed(jn, tn)
    a = np.asarray(jv)
    scale = np.abs(a).max(axis=1, keepdims=True)
    assert _ulps(a, tv.numpy(), scale).max() <= 4.0
    norms = torch.linalg.vector_norm(tv, dim=1)
    assert float((norms - 1.0).abs().max()) < 1e-6

    n = np.random.default_rng(2).normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    jh, jn = ref.rand_hemisphere(jnp.asarray(n), js)
    th, tn = rng.rand_hemisphere(torch.from_numpy(n), ts)
    assert _same_seed(jn, tn)
    a = np.asarray(jh)
    scale = np.abs(a).max(axis=1, keepdims=True)
    assert _ulps(a, th.numpy(), scale).max() <= 4.0
    assert float((th * torch.from_numpy(n)).sum(dim=1).min()) >= -1e-6
