"""Hopper probes of ``scripts/probe_r2.py``: the primitives a wavefront or
treelet traversal design would rest on.

* Pallas probes, each a hand-written kernel in ``csrc/probe_r2.cu`` with
  its plain PyTorch version here: ``pallas_hello`` (``x * 2``),
  ``pallas_onehot_loop`` (a dependent chain of row fetches from a table in
  on-chip memory), ``pallas_lane_gather`` (a chain through each lane's
  private 128-entry table), ``pallas_sublane_gather`` (one row gather) and
  ``pallas_dyn_dma`` (per-bin block copies picked by an index array).
* XLA probes, which were no Pallas kernels and are PyTorch calls here:
  ``sort``, ``argsort_small_range``, ``cumsum`` (wavefront binning),
  ``standalone_gather`` (compaction), ``dep_gather_width`` (dependent row
  gathers by row width) and ``onehot_rates`` (one-hot matrix-product
  fetches). ``jax.random`` keys become a seeded ``torch.Generator``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ray_tracer_2_tpu_torch.kernels.cuda_build import CudaFunction, \
    check_tensor
from ray_tracer_2_tpu_torch.probes.common import CSRC, PEAK_BF16_FLOPS, \
    PEAK_FLOPS, bench, kernel, measure, nbytes, on_cuda, probe

SOURCE = CSRC / "probe_r2.cu"
COLS = 128
HELLO = kernel("pallas_hello", CudaFunction(SOURCE, "rt2_probe_hello", "pip"),
               "scripts/probe_r2.py:216")
ONEHOT_LOOP = kernel("pallas_onehot_loop",
                     CudaFunction(SOURCE, "rt2_probe_onehot_loop",
                                  "piipiipp"),
                     "scripts/probe_r2.py:251")
LANE_GATHER = kernel("pallas_lane_gather",
                     CudaFunction(SOURCE, "rt2_probe_lane_gather", "ppiip"),
                     "scripts/probe_r2.py:283")
SUBLANE_GATHER = kernel("pallas_sublane_gather",
                        CudaFunction(SOURCE, "rt2_probe_sublane_gather",
                                     "ppip"),
                        "scripts/probe_r2.py:308")
DYN_DMA = kernel("pallas_dyn_dma",
                 CudaFunction(SOURCE, "rt2_probe_dyn_dma", "ppiip"),
                 "scripts/probe_r2.py:339")


# ================================================ Pallas probes: kernels ==
def hello(x: torch.Tensor) -> torch.Tensor:
    """``pallas_hello``'s kernel: ``x * 2``."""
    if not on_cuda(x):
        return hello_plain(x)
    check_tensor("x", x, torch.float32, tuple(x.shape), x.device)
    if x.numel() % 4:
        raise ValueError(f"hello: {x.numel()} elements, not a multiple of 4")
    out = torch.empty_like(x)
    HELLO.launch(x, x.numel(), out)
    return out


def hello_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def onehot_loop(tab: torch.Tensor, idx0: torch.Tensor, *, steps: int = 256):
    """``pallas_onehot_loop``'s kernel: ``steps`` dependent fetches
    ``idx = int(tab[idx, 0]) % R`` for each of B lanes, tab (R, 128) f32 or
    bf16 of integers, idx0 (B, 1) int32. Returns (the probe's output (B, 1)
    f32 = the final idx, the sum of every fetched column (B,) int32)."""
    if not on_cuda(tab, idx0):
        return onehot_loop_plain(tab, idx0, steps=steps)
    dev, R, B = tab.device, tab.shape[0], idx0.shape[0]
    if tab.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"onehot_loop: float32 or bfloat16 table, got "
                         f"{tab.dtype}")
    check_tensor("tab", tab, tab.dtype, (R, COLS), dev)
    check_tensor("idx0", idx0, torch.int32, (B, 1), dev)
    if R * COLS * tab.element_size() > 227 * 1024:
        raise ValueError(f"onehot_loop: a {R}-row table does not fit in "
                         f"shared memory")
    out = torch.empty((B, 1), dtype=torch.float32, device=dev)
    sums = torch.empty(B, dtype=torch.int32, device=dev)
    ONEHOT_LOOP.launch(tab, R, int(tab.dtype == torch.bfloat16), idx0, B,
                       steps, out, sums)
    return out, sums


def onehot_loop_plain(tab, idx0, *, steps: int = 256):
    """The plain PyTorch version of ``onehot_loop`` (any device)."""
    R, tabf = tab.shape[0], tab.float()
    idx = idx0[:, 0].long()
    sums = torch.zeros_like(idx)
    for _ in range(steps):
        row = tabf[idx]
        sums += row.long().sum(1)
        idx = row[:, 0].long() % R
    return idx.float()[:, None], sums.int()


def lane_gather(tab: torch.Tensor, idx0: torch.Tensor, *, steps: int = 256):
    """``pallas_lane_gather``'s kernel: ``steps`` dependent fetches
    ``idx = int(tab[b, idx]) % 128`` from lane b's private row of tab
    (B, 128) f32; idx0 (B, 1) int32. Returns the final idx (B, 1) f32."""
    if not on_cuda(tab, idx0):
        return lane_gather_plain(tab, idx0, steps=steps)
    dev, B = tab.device, tab.shape[0]
    check_tensor("tab", tab, torch.float32, (B, COLS), dev)
    check_tensor("idx0", idx0, torch.int32, (B, 1), dev)
    out = torch.empty((B, 1), dtype=torch.float32, device=dev)
    LANE_GATHER.launch(tab, idx0, B, steps, out)
    return out


def lane_gather_plain(tab, idx0, *, steps: int = 256):
    idx = idx0.long()
    for _ in range(steps):
        idx = tab.gather(1, idx).long() % COLS
    return idx.float()


def sublane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pallas_sublane_gather``'s kernel: rows ``tab[idx[:, 0]]`` of tab
    (R, 128) f32 for idx (B, 1) int32 in [0, R)."""
    if not on_cuda(tab, idx):
        return sublane_gather_plain(tab, idx)
    dev, B = tab.device, idx.shape[0]
    check_tensor("tab", tab, torch.float32, (tab.shape[0], COLS), dev)
    check_tensor("idx", idx, torch.int32, (B, 1), dev)
    out = torch.empty((B, COLS), dtype=torch.float32, device=dev)
    SUBLANE_GATHER.launch(tab, idx, B, out)
    return out


def sublane_gather_plain(tab, idx):
    """One ``index_select`` (also the library yardstick)."""
    return tab.index_select(0, idx[:, 0])


def dyn_dma(bins: torch.Tensor, table: torch.Tensor, *, rows: int = 256):
    """``pallas_dyn_dma``'s kernel: output block i (rows x 128) is 2 x the
    table's block ``bins[i]``; bins (n_bins,) int32, table
    (n_blocks * rows, 128) f32."""
    if not on_cuda(bins, table):
        return dyn_dma_plain(bins, table, rows=rows)
    dev, n = table.device, bins.shape[0]
    check_tensor("bins", bins, torch.int32, (n,), dev)
    check_tensor("table", table, torch.float32, (table.shape[0], COLS), dev)
    if table.shape[0] % rows:
        raise ValueError(f"dyn_dma: {table.shape[0]} table rows are not "
                         f"blocks of {rows}")
    out = torch.empty((n * rows, COLS), dtype=torch.float32, device=dev)
    DYN_DMA.launch(table, bins, n, rows, out)
    return out


def dyn_dma_plain(bins, table, *, rows: int = 256):
    """``index_select`` of the blocks, then ``mul`` (also the library
    yardstick)."""
    return table.view(-1, rows * COLS).index_select(0, bins).mul(2.0) \
        .view(-1, COLS)


# ================================================= Pallas probes: runs ===
@probe("pallas_hello")
def p_hello(ctx):
    x = ctx.tensor(np.ones((256, COLS), np.float32))
    measure(ctx, "pallas_hello", {}, hello, (x,),
            lambda t: dict(ms=t * 1e3, ok=True), plain=hello_plain,
            library=hello_plain, ops=x.numel(), nbytes=2 * nbytes(x),
            kernel="pallas_hello", iters=50, kernel_only=True)


@probe("pallas_onehot_loop")
def p_onehot_loop(ctx):
    steps = 256
    for B, R, C, dt in ctx.sizes(((1024, 256, 128, torch.float32),
                                  (1024, 256, 128, torch.bfloat16),
                                  (2048, 512, 128, torch.bfloat16),
                                  (8192, 512, 128, torch.bfloat16))):
        rng = ctx.rng()
        tab = ctx.tensor(rng.integers(0, R, (R, C)).astype(np.float32), dt)
        idx0 = ctx.tensor(rng.integers(0, R, (B, 1)).astype(np.int32))
        measure(ctx, "pallas_onehot_loop",
                dict(B=B, R=R, C=C, dtype=str(dt).split(".")[-1]),
                functools.partial(onehot_loop, steps=steps), (tab, idx0),
                lambda t: dict(us_per_step=t / steps * 1e6,
                               gfetch_per_s=B * steps / t / 1e9),
                plain=functools.partial(onehot_loop_plain, steps=steps),
                ops=B * steps * C, nbytes=nbytes(tab, idx0) + B * 8,
                kernel="pallas_onehot_loop", iters=5)


@probe("pallas_lane_gather")
def p_lane_gather(ctx):
    B, R, steps = 1024, 128, 256
    rng = ctx.rng()
    tab = ctx.tensor(rng.integers(0, R, (B, R)).astype(np.float32))
    idx0 = ctx.tensor(rng.integers(0, R, (B, 1)).astype(np.int32))
    measure(ctx, "pallas_lane_gather", dict(B=B, R=R),
            functools.partial(lane_gather, steps=steps), (tab, idx0),
            lambda t: dict(us_per_step=t / steps * 1e6,
                           gfetch_per_s=B * steps / t / 1e9),
            plain=functools.partial(lane_gather_plain, steps=steps),
            ops=B * steps, nbytes=nbytes(tab, idx0) + B * 4,
            kernel="pallas_lane_gather", iters=5)


@probe("pallas_sublane_gather")
def p_sublane_gather(ctx):
    B, R, C = 256, 512, 128
    rng = ctx.rng()
    tab = ctx.tensor(rng.random((R, C)).astype(np.float32))
    idx = ctx.tensor(rng.integers(0, R, (B, 1)).astype(np.int32))
    rows_read = int(torch.unique(idx).numel())
    measure(ctx, "pallas_sublane_gather", dict(B=B, R=R), sublane_gather,
            (tab, idx),
            lambda t: dict(ms=t * 1e3, grows_per_s=B / t / 1e9, ok=True),
            plain=sublane_gather_plain, library=sublane_gather_plain,
            ops=0, nbytes=(rows_read + B) * C * 4 + nbytes(idx),
            kernel="pallas_sublane_gather", iters=50, kernel_only=True)


@probe("pallas_dyn_dma")
def p_dyn_dma(ctx):
    n_treelets, rows, C, n_bins = 64, 256, 128, 128
    rng = ctx.rng()
    table = ctx.tensor(rng.random((n_treelets * rows, C)).astype(np.float32))
    bins = ctx.tensor(rng.integers(0, n_treelets, n_bins).astype(np.int32))
    block = rows * C * 4
    measure(ctx, "pallas_dyn_dma", dict(n_bins=n_bins,
                                        block_kb=block // 1024),
            functools.partial(dyn_dma, rows=rows), (bins, table),
            lambda t: dict(ms=t * 1e3, gb_per_s=n_bins * block / 1e9 / t),
            plain=functools.partial(dyn_dma_plain, rows=rows),
            library=functools.partial(dyn_dma_plain, rows=rows),
            ops=n_bins * rows * C,
            nbytes=(int(torch.unique(bins).numel()) + n_bins) * block
            + nbytes(bins), kernel="pallas_dyn_dma", iters=50,
            kernel_only=True)


# ====================================== XLA probes as PyTorch calls ======
def sort_key_val(k: torch.Tensor, v: torch.Tensor):
    """``jax.lax.sort_key_val``: keys sorted (stable), values carried."""
    ks, order = torch.sort(k, stable=True)
    return ks, v[order]


def sort_reduction(k, v):
    """The ``sort`` probe's function after its key generation
    (``probe_r2.py:100-101``)."""
    ks, vs = sort_key_val(k, v)
    return ks[::1 << 16].sum() + vs[::1 << 16].sum()


def argsort_take(keys: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """``jnp.take(payload, jnp.argsort(keys), axis=0)`` (stable)."""
    return payload.index_select(0, torch.argsort(keys, stable=True))


def cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=x.dtype)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx)


def dep_gather(table: torch.Tensor, idx0: torch.Tensor, *, steps: int = 64):
    """``dep_gather_width``'s loop: ``steps`` dependent gathers of whole
    rows, the next index from column 0 mod N."""
    N, idx = table.shape[0], idx0
    for _ in range(steps):
        idx = table.index_select(0, idx)[:, 0].int() % N
    return idx


def onehot_fetch(tab: torch.Tensor, idx0: torch.Tensor, *, steps: int = 64):
    """``onehot_rates``' loop: ``steps`` dependent row fetches as one-hot
    matrix products in the table's type (float32 products in full float32:
    PyTorch's default, TF32 off)."""
    R, idx = tab.shape[0], idx0
    iota = torch.arange(R, dtype=idx0.dtype, device=tab.device)
    for _ in range(steps):
        rows = (idx[:, None] == iota[None, :]).to(tab.dtype) @ tab
        idx = rows[:, 0].int() % R
    return idx


def _random_ints(n: int, high: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(0, high, (n,), generator=g, device=dev,
                         dtype=torch.int32)


@probe("sort", library=True)
def p_sort(ctx):
    dev = ctx.device
    for n in ctx.sizes((1 << 20, 4 << 20, 16 << 20)):
        def gen(seed):
            return (_random_ints(n, 64, seed, dev),
                    _random_ints(n, n, seed + 1, dev))

        seeds = iter(range(1, 10000))
        t_gen = bench(lambda: sum(x[::1 << 16].sum()
                                  for x in gen(next(seeds))), dev)
        measure(ctx, "sort", dict(n=n),
                lambda: sort_reduction(*gen(next(seeds))), (),
                lambda t: dict(ms=t * 1e3, gen_ms=t_gen["wall_s"] * 1e3,
                               mkeys_per_s=n / max(t - t_gen["wall_s"],
                                                   1e-9) / 1e6),
                nbytes=16 * n, extra=dict(gen_device_ms=t_gen["device_ms"]))


@probe("argsort_small_range", library=True)
def p_argsort(ctx):
    n = 4 << 20
    rng = ctx.rng()
    keys = ctx.tensor(rng.integers(0, 64, n).astype(np.int32))
    payload = ctx.tensor(rng.random((n, 4)).astype(np.float32))
    measure(ctx, "argsort_small_range", dict(n=n), argsort_take,
            (keys, payload),
            lambda t: dict(ms=t * 1e3, mkeys_per_s=n / t / 1e6),
            nbytes=nbytes(keys) + 2 * nbytes(payload), iters=20)


@probe("cumsum", library=True)
def p_cumsum(ctx):
    for n in ctx.sizes((2 << 20, 16 << 20)):
        x = torch.ones(n, dtype=torch.int32, device=ctx.device)
        measure(ctx, "cumsum", dict(n=n), cumsum, (x,),
                lambda t: dict(ms=t * 1e3), ops=n, nbytes=2 * nbytes(x),
                iters=20)


@probe("standalone_gather", library=True)
def p_standalone_gather(ctx):
    for n_rows, batch, width in ctx.sizes(((20480, 1 << 21, 16),
                                           (20480, 1 << 21, 52),
                                           (131072, 1 << 22, 16),
                                           (20480, 65536, 128))):
        rng = ctx.rng()
        table = ctx.tensor(rng.random((n_rows, width)).astype(np.float32))
        idx = ctx.tensor(rng.integers(0, n_rows, batch).astype(np.int32))
        measure(ctx, "standalone_gather",
                dict(n_rows=n_rows, batch=batch, width=width), take_rows,
                (table, idx),
                lambda t: dict(ms=t * 1e3, grows_per_s=batch / t / 1e9),
                nbytes=nbytes(table, idx) + batch * width * 4, iters=20)


@probe("dep_gather_width", library=True)
def p_dep_gather_width(ctx):
    B, N, steps = 15360, 16384, 64
    for width in ctx.sizes((64, 128, 256, 512, 1024)):
        rng = ctx.rng()
        table = ctx.tensor(rng.integers(0, N, (N, width)).astype(np.float32))
        idx0 = ctx.tensor(rng.integers(0, N, B).astype(np.int32))
        measure(ctx, "dep_gather_width", dict(width_f32=width,
                                              bytes_=width * 4),
                functools.partial(dep_gather, steps=steps), (table, idx0),
                lambda t: dict(us_per_step=t / steps * 1e6,
                               grows_per_s=B * steps / t / 1e9),
                nbytes=nbytes(table, idx0) + B * 4, iters=5)


@probe("onehot_rates", library=True)
def p_onehot_rates(ctx):
    B, steps = 15360, 64
    for R in ctx.sizes((256, 512, 1024, 2048)):
        for C, prec in ((16, "bf16"), (64, "bf16"), (16, "highest"),
                        (64, "highest")):
            rng = ctx.rng()
            dt = torch.bfloat16 if prec == "bf16" else torch.float32
            tab = ctx.tensor(rng.integers(0, R, (R, C)).astype(np.float32),
                             dt)
            idx0 = ctx.tensor(rng.integers(0, R, B).astype(np.int32))
            measure(ctx, "onehot_rates", dict(R=R, C=C, prec=prec),
                    functools.partial(onehot_fetch, steps=steps),
                    (tab, idx0),
                    lambda t: dict(us_per_step=t / steps * 1e6,
                                   grows_per_s=B * steps / t / 1e9),
                    ops=2 * B * R * C * steps,
                    nbytes=nbytes(tab, idx0) + B * 4, iters=5,
                    peak_flops=PEAK_BF16_FLOPS if prec == "bf16"
                    else PEAK_FLOPS)
