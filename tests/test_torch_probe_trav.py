"""The Hopper probes of ``scripts/probe_trav.py`` and ``probe_packet.py``
(``ray_tracer_2_tpu_torch/probes/trav.py``, ``probes/packet.py``) against
the TPU probes, on the CPU.

The scripts run unchanged, in the Pallas TPU interpreter, with their
``bench`` replaced by a recorder that calls the probe once and keeps its
inputs and output; the port's plain version gets the same arrays. The
outputs are float-steered chains (a compare in the slab test picks the next
row), where XLA's CPU code and PyTorch may round one step differently, so
they are held on >= 99% of lanes (trav, sched and packet agreed on every
lane when this was written; leaf's output, a float, on 89% bit for bit and
on all within 2 ulp: see its test).
The probes' outputs hide the chain's index (``idx + 1e9 * 0.9999^K``), so
the port also returns it, and numpy statements of the probe bodies hold
it, with the checksums the port adds, exactly at small sizes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ray_tracer_2_tpu_torch.probes.common import Ctx
from ray_tracer_2_tpu_torch.probes.packet import packet, packet_inputs
from ray_tracer_2_tpu_torch.probes.trav import launch, leaf, trav, \
    trav_inputs
from torch_bridge import BenchRecorder, import_probe_scripts, to_torch
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

import_probe_scripts()
import probe_packet  # noqa: E402
import probe_trav  # noqa: E402

NEED = 0.99


def _record(monkeypatch, module, run, *a):
    rec = BenchRecorder()
    monkeypatch.setattr(module, "bench", rec.bench)
    with pltpu.force_tpu_interpret_mode():
        run(*a)
    (args, out), = rec.calls
    return args, out


def _share_equal(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


# ------------------------------------------------------- numpy statements --
def _np_slab(row, iv, off, tbest):
    tt = row * iv + off
    r = np.roll(tt, 3, 1)
    tmin, tmax = np.minimum(tt, r), np.maximum(tt, r)
    tn = np.maximum(np.maximum(tmin, np.roll(tmin, 1, 1)),
                    np.roll(tmin, 2, 1))
    tf = np.minimum(np.minimum(tmax, np.roll(tmax, 1, 1)),
                    np.roll(tmax, 2, 1))
    return (tf >= tn) & (tn < tbest)


def np_trav(tabs, iv, off, idx0, tid0, R, K, sched):
    """``make_trav``'s body (probe_trav.py:74-106) in numpy, plus the hit
    slots of every step."""
    tab, T = tabs.astype(np.float32), len(tabs) // R
    idx, tid = idx0[:, 0].astype(np.int64), tid0[:, 0].astype(np.int64)
    tbest, hits = np.float32(1e9), np.zeros(len(iv), np.int64)
    for _ in range(K):
        t = np.bincount(tid, minlength=T).argmax() if sched else 0
        row = tab[t * R + idx]
        hit = _np_slab(row, iv, off, tbest)
        hits += hit.sum(1)
        idx = np.where(hit[:, 0], row[:, 12], row[:, 13]).astype(np.int64) % R
        if sched:
            tid = (tid + (row[:, 14].astype(np.int64) & 3)) % T
        tbest = np.float32(tbest * np.float32(0.9999))
    return idx.astype(np.float32) + tbest, idx, tid, hits


def np_leaf(hi, mid, iv, idx0, K, fused=False):
    """``p_leaf``'s body (probe_trav.py:149-167) in numpy; ``fused`` rounds
    ``acc * iv + row`` once, as a fused multiply-add."""
    tab = hi.astype(np.float32) + mid.astype(np.float32)
    idx = idx0[:, 0].astype(np.int64)
    best = np.full(iv.shape, 1e9, np.float32)
    for _ in range(K):
        row = tab[idx]
        acc = row * iv
        for _ in range(6):
            m = (acc.astype(np.float64) * iv + row).astype(np.float32) \
                if fused else acc * iv + row
            acc = np.minimum(m, np.roll(acc, 3, 1))
        best = np.minimum(best, acc)
        idx = best[:, 0].astype(np.int32).astype(np.int64) & 63
    bits = best.view(np.uint32).astype(np.int64).sum(1)
    return best[:, 0] + idx.astype(np.float32), idx, bits


def np_packet(nodes, iv, b, K, depth=48):
    """``probe_packet.run``'s body (probe_packet.py:42-83) in numpy, plus
    each ray's hit slots."""
    N = len(nodes)
    stack, sp, visits = [0] * depth, 1, 0
    tbest, hits = np.float32(1e9), np.zeros(len(iv), np.int64)
    while sp > 0 and visits < K:
        row = nodes[stack[sp - 1]]
        hit = _np_slab(row[None], iv, b, tbest)
        hits += hit.sum(1)
        sp -= 1
        stack[sp] = max(int(row[13]) % N, 1)
        sp += int(hit[:, 6].any())
        stack[sp] = max(int(row[12]) % N, 1)
        sp = min(sp + int(hit[:, 0].any()), depth - 1)
        tbest = np.float32(np.float32(tbest * np.float32(0.9995))
                           + np.float32(0.001))
        visits += 1
    return tbest + np.float32(visits), visits, hits


# ------------------------------------------------------------------ tests --
def test_launch_matches_the_tpu_probe(monkeypatch):
    (x,), out = _record(monkeypatch, probe_trav, probe_trav.p_launch)
    assert np.array_equal(launch(to_torch(x)).numpy(), out)


@pytest.mark.parametrize("B,R,T,sched", [(1024, 64, 320, False),
                                         (8192, 64, 320, True)])
def test_trav_matches_the_tpu_probe(B, R, T, sched):
    K = 256
    with pltpu.force_tpu_interpret_mode():
        f, args = probe_trav.make_trav(B, R, T, K, sched)
        ref = np.asarray(f(*args))
    port_args = trav_inputs(Ctx(device=torch.device("cpu"), seed=0), B, R, T)
    for a, p in zip(args, port_args):      # drawn as the script draws them
        assert torch.equal(to_torch(a), p)
    out, idx, tid, hits = trav(*port_args, R=R, K=K, sched=sched)
    assert out.shape == (B, 1) and out.dtype == torch.float32
    assert _share_equal(out.numpy(), ref) >= NEED
    assert bool(((idx >= 0) & (idx < R)).all()) and int(hits.sum()) > 0


@pytest.mark.parametrize("sched", [False, True])
def test_trav_index_against_numpy(sched):
    rng = np.random.default_rng(3)
    B, R, T, K = 96, 16, 5, 60
    tabs = rng.integers(0, R, (T * R, 128)).astype(np.float32)
    tabs[:, 14] = rng.integers(0, 4, T * R)
    iv = rng.random((B, 128)).astype(np.float32)
    off = rng.random((B, 128)).astype(np.float32)
    idx0 = rng.integers(0, R, (B, 1)).astype(np.int32)
    tid0 = rng.integers(0, T, (B, 1)).astype(np.int32)
    want = np_trav(tabs, iv, off, idx0, tid0, R, K, sched)
    got = trav(to_torch(tabs).to(torch.bfloat16), *map(to_torch, (iv, off,
                                                              idx0, tid0)),
               R=R, K=K, sched=sched)
    assert np.array_equal(got[0].numpy()[:, 0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), w)
    assert len(np.unique(want[1])) > 1
    if sched:
        assert len(np.unique(want[2])) > 1


def test_leaf_matches_the_tpu_probe(monkeypatch):
    """XLA's CPU backend contracts ``acc * iv + row`` into a fused
    multiply-add; the port rounds the product first, as its kernel does
    (built with ``--fmad=false``). So 89% of lanes agree bit for bit and
    every lane within 2 ulp, and a numpy statement of the body with the
    fused form agrees with the JAX probe on every lane (lanes are
    independent: the first 1024 are restated)."""
    K = 128
    (hi, mid, iv, idx0), ref = _record(monkeypatch, probe_trav,
                                       probe_trav.p_leaf)
    out, idx, bits = leaf(*map(to_torch, (hi, mid, iv, idx0)), K=K)
    assert _share_equal(out.numpy(), ref) >= 0.85
    np.testing.assert_allclose(out.numpy(), ref, rtol=2.4e-7, atol=0)
    n = 1024
    fused = np_leaf(hi.astype(np.float32), mid.astype(np.float32), iv[:n],
                    idx0[:n], K, fused=True)[0]
    assert np.array_equal(fused, ref[:n, 0])
    assert bool(((idx >= 0) & (idx < 64)).all())


def test_leaf_index_against_numpy():
    rng = np.random.default_rng(4)
    B, R, K = 64, 64, 24
    base = (rng.random((R, 128)) * 70).astype(np.float32)
    hi = np.asarray(jnp.asarray(base, jnp.bfloat16)).astype(np.float32)
    mid = np.asarray(jnp.asarray(base - hi, jnp.bfloat16)).astype(np.float32)
    iv = rng.random((B, 128)).astype(np.float32)
    idx0 = rng.integers(0, R, (B, 1)).astype(np.int32)
    want = np_leaf(hi, mid, iv, idx0, K)
    got = leaf(to_torch(hi).to(torch.bfloat16),
               to_torch(mid).to(torch.bfloat16), to_torch(iv),
               to_torch(idx0), K=K)
    assert np.array_equal(got[0].numpy()[:, 0], want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(got[2].numpy(), want[2])
    assert len(np.unique(want[1])) > 1


def test_packet_matches_the_tpu_probe(monkeypatch):
    """The script's inputs at P=8 (the first of its sizes), 1024 visits."""
    P, K = 8, 1024
    (nodes, iv, b), ref = _record(monkeypatch, probe_packet,
                                  probe_packet.run, P, K)
    port_args = packet_inputs(Ctx(device=torch.device("cpu"), seed=0), P)
    for a, p in zip((nodes, iv, b), port_args):
        assert torch.equal(to_torch(a), p)
    out, visits, hits = packet(*port_args, K=K)
    assert _share_equal(out.numpy()[0], ref[:, 0]) >= NEED
    assert int(visits[0]) == K


def test_packet_visits_against_numpy():
    """Child ids in slots 12 and 13 drawn over three times the node count
    (the script's rows hold only 0..1 there), so pushes, pops and the
    stack's cap all happen."""
    rng = np.random.default_rng(5)
    N, P, K = 64, 16, 300
    nodes = rng.random((N, 128)).astype(np.float32)
    nodes[:, 12:14] = rng.integers(0, 3 * N, (N, 2))
    iv = rng.random((P, 128)).astype(np.float32)
    b = rng.random((P, 128)).astype(np.float32) - 0.5
    want_out, want_visits, want_hits = np_packet(nodes, iv, b, K)
    out, visits, hits = packet(*map(to_torch, (nodes, iv, b)), K=K,
                               copies=2)
    assert out.shape == (2, P) and bool((visits == want_visits).all())
    assert bool((out == float(want_out)).all())
    assert np.array_equal(hits.numpy(), np.stack([want_hits] * 2))
    assert 0 < int(want_hits.sum()) < P * 128 * want_visits
