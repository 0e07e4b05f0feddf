"""The Hopper probes of ``scripts/probe_lut.py``
(``ray_tracer_2_tpu_torch/probes/lut.py``) against the TPU script, on the
CPU.

The script's probes run unchanged in the Pallas interpreter, ``np.random``
seeded before each, with ``bench`` replaced by a recorder that calls the
probe once and keeps its inputs and output. The port's plain versions get
the same arrays and hold the outputs exactly for the integer chains, on
>= 99% of lanes for ``big_body_compile`` (float-steered; every lane agreed
when this was written), and within 1e-5 (float32) or 1e-2 (bfloat16)
relative for ``mxu_leaf_dense``, whose sums XLA may order otherwise (its
64 steps reach 1e35-1e38 or overflow to +inf, so the script's own kernel
is also run at 40 steps, where every lane is finite). numpy
statements of the bodies hold the final index and the checksums the port
adds exactly at small sizes.
"""
import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ray_tracer_2_tpu_torch.probes.lut import big_body, lane_gather_chain, \
    lut1024_chain, lut_row_fetch, mxu_leaf_dense, scalar_treelet_select, \
    sublane_gather_samey
from torch_bridge import BenchRecorder, import_probe_scripts, to_torch
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

import_probe_scripts()
import probe_lut  # noqa: E402
import probe_r2  # noqa: E402


def run_probe(monkeypatch, name):
    rec = BenchRecorder()
    monkeypatch.setattr(probe_lut, "bench", rec.bench)
    fn, = [p for p in probe_r2.PROBES if p.__name__ == name]
    np.random.seed(0)
    with pltpu.force_tpu_interpret_mode():
        assert fn() is True, f"{name} failed in the JAX package"
    assert rec.calls
    return [([to_torch(a) for a in args], out) for args, out in rec.calls]


@pytest.mark.parametrize("name,fn,n", [
    ("lane_gather_chain", lane_gather_chain, 3),
    ("sublane_gather_samey", sublane_gather_samey, 1),
    ("lut_row_fetch", lut_row_fetch, 3),
    ("scalar_treelet_select", scalar_treelet_select, 1)])
def test_integer_chains_match_the_tpu_probe(monkeypatch, name, fn, n):
    calls = run_probe(monkeypatch, name)
    assert len(calls) == n
    for args, out in calls:
        assert np.array_equal(fn(*args).numpy(), out)


def test_lut1024_chain_matches_the_tpu_probe(monkeypatch):
    """The gather and the select forms, each on its own draw."""
    calls = run_probe(monkeypatch, "lut1024_chain")
    assert len(calls) == 2
    for (args, out), select in zip(calls, (False, True)):
        assert np.array_equal(lut1024_chain(*args, select=select).numpy(),
                              out)
        # the two forms compute one function
        assert np.array_equal(lut1024_chain(*args,
                                            select=not select).numpy(), out)


def test_mxu_leaf_dense_matches_the_tpu_probe(monkeypatch):
    """The sums grow about 4x a step. At the script's 64 steps float32 at
    T = 128 and bfloat16 at T = 512 overflow to +inf on every lane, and
    the other two calls end at 1e35-1e38: the port must overflow on exactly
    the lanes the script does and match it on the rest. The script's
    kernel run again with its ``fori_loop`` cut to 40 steps keeps every
    lane finite (under 1e25), and holds the arithmetic of all four."""
    calls = run_probe(monkeypatch, "mxu_leaf_dense")
    assert [(a[0].dtype, a[1].shape[1]) for a, _ in calls] == [
        (torch.float32, 128), (torch.float32, 512), (torch.bfloat16, 128),
        (torch.bfloat16, 512)]
    finite = []
    for args, out in calls:
        rtol = 1e-5 if args[0].dtype == torch.float32 else 1e-2
        got, bits = mxu_leaf_dense(*args)
        got = got.numpy()
        assert np.array_equal(np.isfinite(got), np.isfinite(out))
        np.testing.assert_allclose(got, out, rtol=rtol, atol=0)
        assert (np.isposinf(out) | (out > 1e30)).all() and int(bits.min()) > 0
        finite.append(float(np.isfinite(out).mean()))
    assert finite[0] == finite[3] == 0.0 and finite[1] == 1.0
    assert 0.5 < finite[2] < 1.0

    fori_loop = jax.lax.fori_loop

    def forty_steps(lower, upper, body, init, **kw):
        assert (lower, upper) == (0, 64)      # the kernel's only loop
        return fori_loop(0, 40, body, init, **kw)

    monkeypatch.setattr(jax.lax, "fori_loop", forty_steps)
    calls = run_probe(monkeypatch, "mxu_leaf_dense")
    assert len(calls) == 4
    for args, out in calls:
        rtol = 1e-5 if args[0].dtype == torch.float32 else 1e-2
        assert np.isfinite(out).all() and 1e20 < np.abs(out).max() < 1e25
        got = mxu_leaf_dense(*args, steps=40)[0].numpy()
        np.testing.assert_allclose(got, out, rtol=rtol, atol=0)


def test_big_body_matches_the_tpu_probe(monkeypatch):
    (args, out), = run_probe(monkeypatch, "big_body_compile")
    got, idx, sums = big_body(*args)
    assert float((got.numpy() == out).mean()) >= 0.99


# ------------------------------------------------------- numpy statements --
def np_lut(tab, idx):
    """``_lut1024`` (probe_lut.py:113) in numpy."""
    g = np.take_along_axis(tab, idx & 127, axis=1)
    return np.take_along_axis(g, idx >> 7, axis=0)


def _inputs(seed, rows, high, idx_high):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, high, (rows, 128)).astype(np.float32),
            rng.integers(0, idx_high, (8, 128)).astype(np.int64))


@pytest.mark.parametrize("select", [False, True])
def test_lut1024_chain_against_numpy(select):
    tab, idx = _inputs(8, 8, 1024, 1024)
    got = lut1024_chain(to_torch(tab), to_torch(idx.astype(np.int32)),
                        steps=37, select=select)
    for _ in range(37):
        idx = np_lut(tab, idx).astype(np.int64) % 1024
    assert np.array_equal(got.numpy(), idx.astype(np.float32))
    assert len(np.unique(idx)) > 10


def test_lut_row_fetch_against_numpy():
    C = 5
    tab, idx = _inputs(9, C * 8, 1024, 1024)
    got = lut_row_fetch(to_torch(tab), to_torch(idx.astype(np.int32)),
                        steps=20)
    for _ in range(20):
        acc = np.zeros((8, 128), np.float32)
        for c in range(C):
            v = np_lut(tab[c * 8:(c + 1) * 8], idx)
            acc = acc + v
            if c == 0:
                nxt = v.astype(np.int64) % 1024
        idx = (nxt + acc.astype(np.int64)) % 1024
    assert np.array_equal(got.numpy(), idx.astype(np.float32))


def test_scalar_treelet_select_against_numpy():
    C, NT = 3, 4
    tab, idx = _inputs(10, NT * C * 8, 3, NT * 1024)
    got = scalar_treelet_select(to_torch(tab), to_torch(idx.astype(np.int32)),
                                steps=25, C=C)
    for _ in range(25):
        tid = idx.min() >> 10
        acc = np.zeros((8, 128), np.float32)
        for c in range(C):
            r0 = tid * C * 8 + c * 8
            acc = acc + np_lut(tab[r0:r0 + 8], idx & 1023)
        idx = (idx + acc.astype(np.int64) + 1) % (NT * 1024)
    assert np.array_equal(got.numpy(), idx.astype(np.float32))


def test_big_body_against_numpy():
    C = 10
    tab, idx = _inputs(11, C * 8, 1024, 1024)
    got, got_idx, got_sums = big_body(to_torch(tab),
                                      to_torch(idx.astype(np.int32)),
                                      steps=16)
    best = np.zeros((8, 128), np.float32)
    sums = np.zeros((8, 128), np.int64)
    for _ in range(16):
        cols = [np_lut(tab[c * 8:(c + 1) * 8], idx) for c in range(C)]
        sums += sum(c.astype(np.int64) for c in cols)
        tmin = np.full((8, 128), -3e38, np.float32)
        tmax = np.full((8, 128), 3e38, np.float32)
        for c in range(0, C - 2, 2):
            t1 = (cols[c] - best) * np.float32(0.5)
            t2 = (cols[c + 1] - best) * np.float32(0.5)
            tmin = np.maximum(tmin, np.minimum(t1, t2))
            tmax = np.minimum(tmax, np.maximum(t1, t2))
        hit = (tmax >= tmin).astype(np.float32)
        idx = (cols[0].astype(np.int64) + idx) % 1024
        best = best + hit * np.float32(0.25)
    assert np.array_equal(got.numpy(), best + idx.astype(np.float32))
    assert np.array_equal(got_idx.numpy(), idx)
    assert np.array_equal(got_sums.numpy(), sums)
    assert 0 < best.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_leaf_dense_against_numpy(dtype):
    """Float32 sums over the 16 features in order; the checksum is the sum
    of every product's bit pattern."""
    rng = np.random.default_rng(12)
    B, T, steps = 24, 40, 9
    rays = torch.from_numpy(rng.random((B, 16)).astype(np.float32)).to(dtype)
    tris = torch.from_numpy(rng.random((16, T)).astype(np.float32)).to(dtype)
    r, t = rays.float().numpy(), tris.float().numpy()
    acc = np.zeros((B, 16), np.float32)
    bits = np.zeros(B, np.int64)
    for _ in range(steps):
        x = torch.from_numpy(r + acc).to(dtype).float().numpy() \
            if dtype == torch.bfloat16 else r + acc
        p = x[:, :1] * t[:1]
        for f in range(1, 16):
            p = p + x[:, f:f + 1] * t[f:f + 1]
        bits += p.view(np.uint32).astype(np.int64).sum(1)
        acc = torch.from_numpy(p[:, :16]).to(dtype).float().numpy() \
            * np.float32(0.5)
    got, got_bits = mxu_leaf_dense(rays, tris, steps=steps)
    assert np.array_equal(got.numpy(), acc)
    assert np.array_equal(got_bits.numpy(), bits)
