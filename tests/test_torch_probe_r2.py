"""The Hopper probes of ``scripts/probe_r2.py``
(``ray_tracer_2_tpu_torch/probes/r2.py``) against the TPU script, on the
CPU, and the probes' entry point.

The script's probes run unchanged (its Pallas kernels in the TPU
interpreter), ``np.random`` seeded before each, with ``bench`` and
``bench_varying`` replaced by a recorder that calls the probe once and
keeps its inputs and output. The port gets the same arrays; its plain
versions hold the Pallas probes' outputs exactly (integer chains and
copies), and its PyTorch calls the XLA probes' outputs exactly. Sizes too
large for the CPU are skipped by the recorder, never shrunk. numpy
statements of the chains hold the port's final index and checksum at small
sizes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ray_tracer_2_tpu_torch.probes import common, load_all
from ray_tracer_2_tpu_torch.probes.r2 import argsort_take, cumsum, \
    dep_gather, dyn_dma, hello, lane_gather, onehot_fetch, onehot_loop, \
    sort_reduction, sublane_gather, take_rows
from torch_bridge import BenchRecorder, import_probe_scripts, to_torch
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

import_probe_scripts()
import probe_r2  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def run_probe(monkeypatch, name, keep=None):
    """Run the script's probe ``name`` with ``np.random`` seeded; return
    the recorded (inputs, output) pairs."""
    rec = BenchRecorder(keep)
    monkeypatch.setattr(probe_r2, "bench", rec.bench)
    monkeypatch.setattr(probe_r2, "bench_varying", rec.bench_varying)
    fn, = [p for p in probe_r2.PROBES if p.__name__ == name]
    np.random.seed(0)
    with pltpu.force_tpu_interpret_mode():
        assert fn() is True, f"{name} failed in the JAX package"
    assert rec.calls
    return rec.calls


def _eq(port, ref):
    port = port.float().numpy() if port.dtype == torch.bfloat16 \
        else port.numpy()
    assert port.shape == np.shape(ref)
    assert np.array_equal(port, np.asarray(ref, port.dtype))


# ---------------------------------------------------------- Pallas probes --
def test_pallas_hello(monkeypatch):
    (args, out), = run_probe(monkeypatch, "pallas_hello")
    _eq(hello(to_torch(args[0])), out)


def test_pallas_onehot_loop(monkeypatch):
    calls = run_probe(monkeypatch, "pallas_onehot_loop")
    assert [a[0].dtype.name for a, _ in calls] == \
        ["float32", "bfloat16", "bfloat16", "bfloat16"]
    for (tab, idx0), out in calls:
        port, sums = onehot_loop(to_torch(tab), to_torch(idx0))
        _eq(port, out)
        assert int(sums.min()) > 0


def test_pallas_lane_gather(monkeypatch):
    (args, out), = run_probe(monkeypatch, "pallas_lane_gather")
    _eq(lane_gather(*map(to_torch, args)), out)


def test_pallas_sublane_gather(monkeypatch):
    (args, out), = run_probe(monkeypatch, "pallas_sublane_gather")
    _eq(sublane_gather(*map(to_torch, args)), out)


def test_pallas_dyn_dma(monkeypatch):
    (args, out), = run_probe(monkeypatch, "pallas_dyn_dma")
    _eq(dyn_dma(*map(to_torch, args)), out)


def np_onehot_loop(tab, idx0, steps):
    idx, sums = idx0[:, 0].astype(np.int64), np.zeros(len(idx0), np.int64)
    for _ in range(steps):
        row = tab[idx]
        sums += row.astype(np.int64).sum(1)
        idx = row[:, 0].astype(np.int64) % len(tab)
    return idx, sums


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_loop_against_numpy(dtype):
    rng = np.random.default_rng(6)
    R, B, steps = 40, 50, 30
    tab = rng.integers(0, R, (R, 128)).astype(np.float32)
    idx0 = rng.integers(0, R, (B, 1)).astype(np.int32)
    idx, sums = np_onehot_loop(tab, idx0, steps)
    out, got = onehot_loop(to_torch(tab).to(dtype), to_torch(idx0),
                           steps=steps)
    assert np.array_equal(out.numpy()[:, 0], idx.astype(np.float32))
    assert np.array_equal(got.numpy(), sums)


def test_lane_gather_against_numpy():
    rng = np.random.default_rng(7)
    tab = rng.integers(0, 128, (20, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (20, 1))
    want = idx[:, 0].copy()
    for _ in range(33):
        want = tab[np.arange(20), want].astype(np.int64) % 128
    got = lane_gather(to_torch(tab), to_torch(idx.astype(np.int32)),
                      steps=33)
    assert np.array_equal(got.numpy()[:, 0], want.astype(np.float32))


# ------------------------------------------------ XLA probes as PyTorch ----
def test_sort(monkeypatch):
    """The first size (2^20 keys): the port sorts JAX's random keys and
    values and gives the probe's reduction."""
    (args, out), = run_probe(monkeypatch, "sort", keep={0})
    n, seed = 1 << 20, int(args[0])
    k = jax.random.randint(jax.random.key(seed), (n,), 0, 64, jnp.int32)
    v = jax.random.randint(jax.random.key(seed + 1), (n,), 0, n, jnp.int32)
    assert int(sort_reduction(to_torch(k), to_torch(v))) == int(out)


def test_argsort_small_range(monkeypatch):
    (args, out), = run_probe(monkeypatch, "argsort_small_range")
    _eq(argsort_take(*map(to_torch, args)), out)


def test_cumsum(monkeypatch):
    calls = run_probe(monkeypatch, "cumsum")
    assert len(calls) == 2
    for (x,), out in calls:
        _eq(cumsum(to_torch(x)), out)


def test_standalone_gather(monkeypatch):
    """The last size (65,536 rows of 128); the first three make 128-416 MB
    on the CPU."""
    (args, out), = run_probe(monkeypatch, "standalone_gather", keep={3})
    _eq(take_rows(*map(to_torch, args)), out)


def test_dep_gather_width(monkeypatch):
    """The first width (64 floats)."""
    (args, out), = run_probe(monkeypatch, "dep_gather_width", keep={0})
    _eq(dep_gather(*map(to_torch, args)), out)


def test_onehot_rates(monkeypatch):
    """R = 256, C = 16, in bf16 and in f32 (HIGHEST)."""
    calls = run_probe(monkeypatch, "onehot_rates", keep={0, 2})
    assert [a[0].dtype.name for a, _ in calls] == ["bfloat16", "float32"]
    for args, out in calls:
        _eq(onehot_fetch(*map(to_torch, args)), out)


# ------------------------------------------------------------ entry point --
def _entry(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m",
                           "ray_tracer_2_tpu_torch.probes", *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_entry_point_refuses_without_a_card():
    res = _entry("pallas_hello")
    assert res.returncode != 0
    assert '"probe": "pallas_hello"' not in res.stdout


def test_entry_point_runs_the_plain_versions_on_the_cpu():
    res = _entry("pallas_hello", "launch", "--device", "cpu", "--seed", "3")
    assert res.returncode == 0, res.stderr
    lines = [json.loads(ln) for ln in res.stdout.splitlines()]
    assert all(ln["card"] == "cpu" for ln in lines)
    by = {ln["probe"]: ln for ln in lines if ln["probe"] != "done"}
    assert set(by) == {"env", "pallas_hello", "launch"}
    assert by["pallas_hello"]["ok"] is True and "ms" in by["pallas_hello"]
    assert "ms_per_call" in by["launch"]
    for ln in (by["pallas_hello"], by["launch"]):
        assert ln["card"] == "cpu" and ln["device_ms"] is None
        assert ln["bound_by"] == "bytes" and ln["bound_ms"] > 0


def test_a_failed_probe_is_reported_and_fails_the_run(capsys):
    load_all()
    ctx = common.Ctx(device=torch.device("cpu"))

    def broken(ctx):
        raise RuntimeError("kernel did not build")

    common.PROBES.append(("broken_probe", broken))
    try:
        assert common.run(ctx, ["broken_probe"]) is False
        assert common.run(ctx, ["pallas_hello"]) is True
        with pytest.raises(ValueError, match="unknown probes"):
            common.run(ctx, ["no_such_probe"])
    finally:
        common.PROBES.remove(("broken_probe", broken))
    err = json.loads(capsys.readouterr().out.splitlines()[0])
    assert err["probe"] == "broken_probe"
    assert "kernel did not build" in err["error"]


def test_compare_holds_every_output():
    a = (torch.tensor([1.0, float("inf")]), torch.tensor([3, 4]))
    assert common.compare(a, (a[0].clone(), a[1].clone())) == (True, 0.0)
    assert common.compare(a, (torch.tensor([1.5, float("inf")]), a[1])) == \
        (False, 0.5)
    assert common.compare(a, (a[0], torch.tensor([3, 6])))[0] is False
    assert common.compare(a, (a[0],))[0] is False
