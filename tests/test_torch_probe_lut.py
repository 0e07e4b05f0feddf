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


# --------------------------------------------- the tensor-core form's gate --
# On the card the bfloat16 products can run on the tensor cores
# (``form="mma"``), which add the 16 terms of a product in the unit's own
# order, so that form is held to ``mma_gate``, not bit for bit. These tests
# show, on the CPU, that the gate can be met and is not loose: a float32
# accumulation of the same exact bf16 x bf16 products in another order
# (a seeded random order per step, or pairwise) stands for the class the
# tensor core belongs to.
from ray_tracer_2_tpu_torch.probes.lut import (  # noqa: E402
    MMA_MASK_SHARE, MMA_RTOL, mma_gate, mxu_leaf_dense_plain,
)


def _reordered(rays, tris, steps, order):
    """``mxu_leaf_dense_plain(form="mma")`` with each product's 16 terms
    added in float32 in another order: ``order`` = "pairwise" or a numpy
    Generator (a fresh permutation of the features every step)."""
    tf = tris.float()
    acc = torch.zeros_like(rays)
    sums = torch.zeros(rays.shape[0], dtype=torch.float64)
    for _ in range(steps):
        x = (rays + acc).float()
        terms = [x[:, f:f + 1] * tf[f:f + 1] for f in range(16)]
        if order == "pairwise":
            while len(terms) > 1:
                terms = [a + b for a, b in zip(terms[::2], terms[1::2])]
            p = terms[0]
        else:
            perm = order.permutation(16)
            p = terms[perm[0]]
            for f in perm[1:]:
                p = p + terms[f]
        sums += p.double().sum(1)
        acc = p[:, :16].to(rays.dtype) * 0.5
    return acc.float(), sums


def _bf16_inputs(T, B=1024, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((B, 16)).astype(np.float32))
            .to(torch.bfloat16),
            torch.from_numpy(rng.random((16, T)).astype(np.float32))
            .to(torch.bfloat16))


@pytest.mark.parametrize("order", ["pairwise", "random"])
@pytest.mark.parametrize("T", [128, 512])
def test_mma_gate_holds_an_order_free_accumulation(T, order):
    """At the probe's own size and 64 steps, a float32 sum of the exact
    bf16 x bf16 products in another order passes the gate the card holds
    the tensor-core form to, with room: the order moves a product by at
    most 2e-7 of its value (a sum of 16-bit products is often exact in 24
    bits), which never tipped a bf16 rounding of the chain here, so the
    outputs are equal and the column sums agree to 1e-6. The gate's 1e-2
    is not loose for all that: an output is a bfloat16 value, so the
    smallest difference it can show is one rounding, 3.9e-3 to 7.8e-3 of
    the value; any tolerance below that demands bit-equality, which a unit
    that adds in its own order cannot promise, and 1e-2 is the first
    decimal step that admits one rounding and not two."""
    rays, tris = _bf16_inputs(T)
    ref = mxu_leaf_dense_plain(rays, tris, steps=64, form="mma")
    got = _reordered(rays, tris, 64, order if order == "pairwise"
                     else np.random.default_rng(5))
    g = mma_gate(got, ref)
    assert g["ok"], g
    assert g["rtol"] == MMA_RTOL == 1e-2
    assert g["out_mask_share"] == g["col_sum_mask_share"] == 1.0
    assert MMA_MASK_SHARE == 0.999
    assert g["out_max_rel_err"] == 0.0 or \
        2.0 ** -9 <= g["out_max_rel_err"] <= 2.0 ** -7
    assert 0.0 < g["col_sum_max_rel_err"] < 1e-6     # the order does matter
    one_ulp = (ref[0] * (1 + 2.0 ** -8), ref[1])     # one rounding off: in
    assert mma_gate(one_ulp, ref)["ok"]
    two_ulp = (ref[0] * (1 + 2.0 ** -6), ref[1])     # two and more: out
    assert not mma_gate(two_ulp, ref)["ok"]


@pytest.mark.parametrize("T,steps,border", [(128, 65, True), (512, 70, True),
                                            (128, 72, False)])
def test_mma_gate_where_the_chain_overflows(T, steps, border):
    """The step counts of the probe's overflow lines (``OVERFLOW_STEPS``):
    at the border some lanes are still finite, at 72 none. A float32 sum in
    another order overflows on the same rays (mask share 1.0 here; the gate
    asks 0.999, one ray of 1024), and the finite ones stay inside the
    tolerance."""
    from ray_tracer_2_tpu_torch.probes.lut import OVERFLOW_STEPS
    assert steps in OVERFLOW_STEPS
    rays, tris = _bf16_inputs(T)
    ref = mxu_leaf_dense_plain(rays, tris, steps=steps, form="mma")
    for order in ("pairwise", np.random.default_rng(7)):
        g = mma_gate(_reordered(rays, tris, steps, order), ref)
        assert g["ok"], g
        assert g["out_mask_share"] == g["col_sum_mask_share"] == 1.0
        assert (0.0 < g["out_finite_share"] < 1.0) if border \
            else g["out_finite_share"] == 0.0
    flipped = (ref[0].clone(), ref[1].clone())      # two rays' overflow lost
    flipped[1][:2] = torch.where(torch.isfinite(flipped[1][:2]),
                                 float("inf"), 1.0).double()
    assert not mma_gate(flipped, ref)["ok"]


def test_mma_gate_refuses_a_wrong_product():
    """One feature dropped from the sum, or a whole ray's overflow lost, is
    outside the gate."""
    rays, tris = _bf16_inputs(128, B=64)
    ref = mxu_leaf_dense_plain(rays, tris, steps=40, form="mma")
    wrong = tris.clone()
    wrong[15] = 0
    assert not mma_gate(mxu_leaf_dense_plain(rays, wrong, steps=40,
                                             form="mma"), ref)["ok"]
    lost = (ref[0].clone(), ref[1].clone())
    lost[0][0] = float("inf")
    assert not mma_gate(lost, ref)["ok"]
    assert mma_gate(ref, ref)["ok"]


def test_mma_form_against_the_tpu_probe_at_40_steps(monkeypatch):
    """The script's own kernel cut to 40 steps (every lane finite, as in
    ``test_mxu_leaf_dense_matches_the_tpu_probe``) against the plain
    version and against the reordered sums, through the card's gate on the
    output: the class the tensor-core form belongs to stays inside it."""
    fori_loop = jax.lax.fori_loop
    monkeypatch.setattr(
        jax.lax, "fori_loop",
        lambda lo, hi, body, init, **kw: fori_loop(0, 40, body, init, **kw))
    calls = [c for c in run_probe(monkeypatch, "mxu_leaf_dense")
             if c[0][0].dtype == torch.bfloat16]
    assert [c[0][1].shape[1] for c in calls] == [128, 512]
    for (rays, tris), out in calls:
        want = torch.from_numpy(np.asarray(out, np.float32))
        for got in (mxu_leaf_dense_plain(rays, tris, steps=40, form="mma"),
                    _reordered(rays, tris, 40, "pairwise"),
                    _reordered(rays, tris, 40, np.random.default_rng(6))):
            g = mma_gate((got[0], got[1]), (want, got[1]))
            assert g["ok"] and g["out_finite_share"] == 1.0, g


def test_mma_column_sum_against_numpy():
    """``form="mma"`` of the plain version: the output of the SIMT form and
    the float64 sum of every float32 product column of every step."""
    rng = np.random.default_rng(13)
    B, T, steps = 24, 40, 9
    rays = torch.from_numpy(rng.random((B, 16)).astype(np.float32)) \
        .to(torch.bfloat16)
    tris = torch.from_numpy(rng.random((16, T)).astype(np.float32)) \
        .to(torch.bfloat16)
    r, t = rays.float().numpy(), tris.float().numpy()
    acc = np.zeros((B, 16), np.float32)
    sums = np.zeros(B, np.float64)
    for _ in range(steps):
        x = torch.from_numpy(r + acc).to(torch.bfloat16).float().numpy()
        p = x[:, :1] * t[:1]
        for f in range(1, 16):
            p = p + x[:, f:f + 1] * t[f:f + 1]
        sums += p.astype(np.float64).sum(1)
        acc = torch.from_numpy(p[:, :16]).to(torch.bfloat16).float().numpy() \
            * np.float32(0.5)
    got, got_sums = mxu_leaf_dense(rays, tris, steps=steps, form="mma")
    assert np.array_equal(got.numpy(), acc)
    assert got_sums.dtype == torch.float64
    np.testing.assert_allclose(got_sums.numpy(), sums, rtol=1e-12)
    assert np.array_equal(mxu_leaf_dense(rays, tris, steps=steps)[0].numpy(),
                          acc)


_LUT_KERNELS = ["lane_gather_chain", "sublane_gather_samey", "lut1024_chain",
                "lut_row_fetch", "scalar_treelet_select", "mxu_leaf_dense",
                "mxu_leaf_dense_mma", "big_body_compile"]


@pytest.mark.parametrize("name", _LUT_KERNELS)
def test_signature_matches_the_entry_point(name):
    """One ctypes type per parameter of the kernel's ``extern "C"`` entry
    point in ``csrc/probe_lut.cu``: pointers (the stream last) as
    ``c_void_p``, ints as ``c_int``."""
    import ctypes
    import re

    from ray_tracer_2_tpu_torch.probes import lut
    from ray_tracer_2_tpu_torch.probes.common import KERNELS
    assert [k for k, (w, _) in KERNELS.items() if w.source == lut.SOURCE] \
        == _LUT_KERNELS
    wrapper = KERNELS[name][0]
    m = re.search(rf'extern "C" int {wrapper.symbol}\((.*?)\)\s*{{',
                  lut.SOURCE.read_text(), re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(wrapper.argtypes)
    for p, t in zip(params, wrapper.argtypes):
        if "*" in p:
            assert t is ctypes.c_void_p, p
        else:
            assert p.startswith("int ") and t is ctypes.c_int, p
    assert params[-1] == "void* stream"


def test_mxu_leaf_dense_refuses_unknown_forms():
    rays, tris = _bf16_inputs(16, B=4)
    with pytest.raises(ValueError, match="form"):
        mxu_leaf_dense(rays, tris, form="wgmma")
