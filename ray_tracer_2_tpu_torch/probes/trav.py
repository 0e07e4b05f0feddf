"""Hopper probes of ``scripts/probe_trav.py``: the fixed cost of a launch
(``launch``), a traversal-shaped chain of dependent row fetches with slab
math in slot space (``trav``), the same with a table picked every step by a
histogram over all lanes (``sched``), and a split-bf16 row fetch with
leaf-test-sized arithmetic (``leaf``).

Kernels: ``csrc/probe_trav.cu``. A lane's 128-slot row is one warp (four
slots a thread; ``pltpu.roll`` through warp shuffles), so ``trav`` measures
the warp-cooperative row walk. It runs twice per size: table 0 staged in
shared memory, and read from global memory as the megakernel reads its
wide rows. ``sched`` needs every lane's table id each step: one
cooperative launch with a grid barrier per step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ray_tracer_2_tpu_torch.kernels.cuda_build import CudaFunction, \
    check_tensor
from ray_tracer_2_tpu_torch.probes.common import CSRC, kernel, measure, \
    nbytes, on_cuda, probe

SOURCE = CSRC / "probe_trav.cu"
SLOTS = 128
LAUNCH = kernel("launch", CudaFunction(SOURCE, "rt2_probe_launch", "pip"),
                "scripts/probe_trav.py:59")
TRAV = kernel("trav", CudaFunction(SOURCE, "rt2_probe_trav", "pipppiiippp"),
              "scripts/probe_trav.py:115")
TRAV_SCHED = CudaFunction(SOURCE, "rt2_probe_trav_sched", "piippppiippppp")
LEAF = kernel("leaf", CudaFunction(SOURCE, "rt2_probe_leaf", "ppippiippp"),
              "scripts/probe_trav.py:175")
#: float operations per slot and step (read off csrc/probe_trav.cu):
#: trav's slab test (mul, add, min, max, 2 max, 2 min, 2 compares, and),
#: leaf's row sum, first product, 6 rounds of mul/add/min and the best min
OPS_TRAV_SLOT = 11
OPS_LEAF_SLOT = 21


# --------------------------------------------------------------- launch --
def launch(x: torch.Tensor) -> torch.Tensor:
    """``p_launch``'s kernel: ``x + 1``."""
    if not on_cuda(x):
        return launch_plain(x)
    check_tensor("x", x, torch.float32, tuple(x.shape), x.device)
    out = torch.empty_like(x)
    LAUNCH.launch(x, x.numel(), out)
    return out


def launch_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


# ----------------------------------------------------------------- trav --
def trav(tabs, iv, off, idx0, tid0, *, R: int, K: int, sched: bool = False,
         staged: bool = True):
    """``make_trav(B, R, T, K, sched)``'s kernel on its inputs: tabs
    (T*R, 128) bf16, iv and off (B, 128) f32, idx0 and tid0 (B, 1) int32.
    Returns (the probe's output (B, 1) f32 = idx + tbest, the final idx
    (B,) int32, the final table ids (B,) int32, the hit slots of all steps
    per lane (B,) int32). ``staged`` (kernel only, without ``sched``):
    table 0 in shared memory rather than global memory."""
    if not on_cuda(tabs, iv, off, idx0, tid0):
        return trav_plain(tabs, iv, off, idx0, tid0, R=R, K=K, sched=sched)
    dev, B = iv.device, iv.shape[0]
    T = tabs.shape[0] // R
    check_tensor("tabs", tabs, torch.bfloat16, (T * R, SLOTS), dev)
    for name, x in (("iv", iv), ("off", off)):
        check_tensor(name, x, torch.float32, (B, SLOTS), dev)
    for name, x in (("idx0", idx0), ("tid0", tid0)):
        check_tensor(name, x, torch.int32, (B, 1), dev)
    out = torch.empty((B, 1), dtype=torch.float32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    hits = torch.empty(B, dtype=torch.int32, device=dev)
    if sched:
        tid = torch.empty(B, dtype=torch.int32, device=dev)
        hist = torch.zeros(3 * T, dtype=torch.int32, device=dev)
        TRAV_SCHED.launch(tabs, R, T, iv, off, idx0, tid0, B, K, hist, out,
                          idx, tid, hits)
        return out, idx, tid, hits
    TRAV.launch(tabs, R, iv, off, idx0, B, K, int(staged), out, idx, hits)
    return out, idx, tid0[:, 0].clone(), hits


def _slab(row, iv, off, tbest):
    """The slab test in slot space (``probe_trav.py:88-95``): the hit of
    every slot."""
    tt = row * iv + off
    r = torch.roll(tt, 3, 1)
    tmin, tmax = torch.minimum(tt, r), torch.maximum(tt, r)
    tn = torch.maximum(torch.maximum(tmin, torch.roll(tmin, 1, 1)),
                       torch.roll(tmin, 2, 1))
    tf = torch.minimum(torch.minimum(tmax, torch.roll(tmax, 1, 1)),
                       torch.roll(tmax, 2, 1))
    return (tf >= tn) & (tn < tbest)


def f32_chain(start: float, mul: float, add: float, n: int):
    """The float32 values x_0 = start, x_{k+1} = x_k * mul + add (each op
    rounded to float32): the probes' ``tbest`` at every step."""
    x, out = torch.tensor(start, dtype=torch.float32), []
    for _ in range(n + 1):
        out.append(float(x))
        x = x * mul + add if add else x * mul
    return out


def trav_plain(tabs, iv, off, idx0, tid0, *, R: int, K: int,
               sched: bool = False):
    """The plain PyTorch version of ``trav`` (any device)."""
    B, T = iv.shape[0], tabs.shape[0] // R
    tab = tabs.float()
    idx, tid = idx0[:, 0].long(), tid0[:, 0].long()
    hits = torch.zeros(B, dtype=torch.int32, device=iv.device)
    tb = f32_chain(1e9, 0.9999, 0.0, K)
    for k in range(K):
        base = torch.bincount(tid, minlength=T).argmax() * R if sched else 0
        row = tab[base + idx]
        hit = _slab(row, iv, off, tb[k])
        hits += hit.sum(1, dtype=torch.int32)
        idx = torch.where(hit[:, 0], row[:, 12], row[:, 13]).long() % R
        if sched:
            tid = (tid + (row[:, 14].long() & 3)) % T
    out = (idx.float() + tb[K])[:, None]
    return out, idx.int(), tid.int(), hits


def trav_inputs(ctx, B: int, R: int, T: int):
    """``make_trav``'s inputs, drawn as it draws them (``probe_trav.py:
    108-114``) from ``ctx.seed``."""
    rng = ctx.rng()
    tabs = rng.integers(0, R, (T * R, SLOTS)).astype(np.float32)
    iv = rng.random((B, SLOTS)).astype(np.float32)
    off = rng.random((B, SLOTS)).astype(np.float32)
    idx0 = rng.integers(0, R, (B, 1)).astype(np.int32)
    tid0 = rng.integers(0, T, (B, 1)).astype(np.int32)
    return (ctx.tensor(tabs, torch.bfloat16), ctx.tensor(iv), ctx.tensor(off),
            ctx.tensor(idx0), ctx.tensor(tid0))


def _trav_work(args, R, K, sched):
    tabs, iv, off, idx0, tid0 = args
    B, T = iv.shape[0], tabs.shape[0] // R
    ops = B * K * SLOTS * OPS_TRAV_SLOT + (B * K + K * T if sched else 0)
    table = tabs if sched else tabs[:R]
    return ops, nbytes(table, iv, off, idx0, tid0) + B * 4 * (4 if sched
                                                              else 3)


@probe("launch")
def p_launch(ctx):
    x = ctx.tensor(np.ones((8, SLOTS), np.float32))
    measure(ctx, "launch", {}, launch, (x,),
            lambda t: dict(ms_per_call=t * 1e3), plain=launch_plain,
            library=launch_plain, ops=x.numel(), nbytes=2 * nbytes(x),
            kernel="launch", iters=50)


@probe("trav")
def p_trav(ctx):
    K = 256
    for B, R in ctx.sizes(((1024, 64), (4096, 64), (8192, 64), (8192, 128),
                           (16384, 64))):
        T = max(20480 // R, 1)
        args = trav_inputs(ctx, B, R, T)
        ops, nb = _trav_work(args, R, K, False)
        tables = ("shared", "global") if ctx.device.type == "cuda" \
            else ("plain",)
        for table in tables:
            measure(ctx, "trav", dict(B=B, R=R, table=table),
                    functools.partial(trav, R=R, K=K,
                                      staged=table == "shared"), args,
                    lambda t: dict(us_per_step=t / K * 1e6,
                                   gvisit_per_s=B * K / t / 1e9),
                    plain=functools.partial(trav_plain, R=R, K=K),
                    ops=ops, nbytes=nb, kernel="trav", iters=5)


@probe("sched")
def p_sched(ctx):
    K = 256
    for B, R, T in ctx.sizes(((8192, 64, 320), (16384, 64, 320))):
        args = trav_inputs(ctx, B, R, T)
        ops, nb = _trav_work(args, R, K, True)
        measure(ctx, "sched", dict(B=B, R=R, T=T),
                functools.partial(trav, R=R, K=K, sched=True), args,
                lambda t: dict(us_per_step=t / K * 1e6,
                               gvisit_per_s=B * K / t / 1e9),
                plain=functools.partial(trav_plain, R=R, K=K, sched=True),
                ops=ops, nbytes=nb, kernel="trav_sched", iters=5)


# ----------------------------------------------------------------- leaf --
def leaf(hi, mid, iv, idx0, *, K: int):
    """``p_leaf``'s kernel on its inputs: hi and mid (R, 128) bf16 (the two
    halves of an f32 table), iv (B, 128) f32, idx0 (B, 1) int32. Returns
    (the probe's output (B, 1) = best[:, 0] + idx, the final idx (B,)
    int32, the sum of the bit patterns of the final ``best`` row (B,)
    int64)."""
    if not on_cuda(hi, mid, iv, idx0):
        return leaf_plain(hi, mid, iv, idx0, K=K)
    dev, B, R = iv.device, iv.shape[0], hi.shape[0]
    for name, x in (("hi", hi), ("mid", mid)):
        check_tensor(name, x, torch.bfloat16, (R, SLOTS), dev)
    check_tensor("iv", iv, torch.float32, (B, SLOTS), dev)
    check_tensor("idx0", idx0, torch.int32, (B, 1), dev)
    if R < 64:
        raise ValueError(f"leaf: idx & 63 needs a table of >= 64 rows, got "
                         f"{R}")
    out = torch.empty((B, 1), dtype=torch.float32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    bits = torch.empty(B, dtype=torch.int64, device=dev)
    LEAF.launch(hi, mid, R, iv, idx0, B, K, out, idx, bits)
    return out, idx, bits


def bit_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of the float32 bit patterns, as unsigned, in
    int64: an order-free checksum that every bit of ``x`` moves."""
    return (x.contiguous().view(torch.int32).long() & 0xFFFFFFFF).sum(-1)


def leaf_plain(hi, mid, iv, idx0, *, K: int):
    """The plain PyTorch version of ``leaf`` (any device)."""
    B = iv.shape[0]
    tab = hi.float() + mid.float()
    idx = idx0[:, 0].long()
    best = torch.full((B, SLOTS), 1e9, dtype=torch.float32, device=iv.device)
    for _ in range(K):
        row = tab[idx]
        acc = row * iv
        for _ in range(6):
            acc = torch.minimum(acc * iv + row, torch.roll(acc, 3, 1))
        best = torch.minimum(best, acc)
        idx = best[:, 0].int().long() & 63
    return best[:, :1] + idx.float()[:, None], idx.int(), bit_sum(best)


@probe("leaf")
def p_leaf(ctx):
    B, R, K = 8192, 64, 128
    rng = ctx.rng()
    base = rng.random((R, SLOTS)).astype(np.float32)
    hi = ctx.tensor(base, torch.bfloat16)
    mid = (ctx.tensor(base) - hi.float()).to(torch.bfloat16)
    iv = ctx.tensor(rng.random((B, SLOTS)).astype(np.float32))
    idx0 = ctx.tensor(rng.integers(0, R, (B, 1)).astype(np.int32))
    measure(ctx, "leaf", dict(B=B, R=R), functools.partial(leaf, K=K),
            (hi, mid, iv, idx0),
            lambda t: dict(us_per_step=t / K * 1e6,
                           gleaf_per_s=B * K / t / 1e9),
            plain=functools.partial(leaf_plain, K=K),
            ops=B * K * SLOTS * OPS_LEAF_SLOT,
            nbytes=nbytes(hi, mid, iv, idx0) + B * 16, kernel="leaf",
            iters=5)
