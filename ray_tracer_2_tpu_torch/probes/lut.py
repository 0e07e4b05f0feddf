"""Hopper probes of ``scripts/probe_lut.py``: per-lane fetches from small
tables, the two-level 1024-entry LUT (``_lut1024``), a treelet staged per
step after a block-wide min, and a dense ray-by-triangle product as a leaf
test.

Kernels: ``csrc/probe_lut.cu``; an (8, 128) vreg block is one block of 1024
threads. The plain versions here state each probe body in PyTorch; as
``probe_lut.py`` takes its helpers from ``probe_r2``, this module takes its
shared ones from ``probes/r2.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ray_tracer_2_tpu_torch.kernels.cuda_build import CudaFunction, \
    check_tensor
from ray_tracer_2_tpu_torch.probes.common import CSRC, PEAK_BF16_FLOPS, \
    PEAK_FLOPS, PEAK_FLOPS_NOFMA, ProbeMismatch, emit, graph_ms, kernel, \
    measure, nbytes, on_cuda, probe
from ray_tracer_2_tpu_torch.probes.r2 import COLS
from ray_tracer_2_tpu_torch.probes.trav import bit_sum

SOURCE = CSRC / "probe_lut.cu"
SUB = 8                       # sublanes of a vreg block
FEAT = 16                     # mxu_leaf_dense's features per ray
LANE_GATHER_CHAIN = kernel(
    "lane_gather_chain",
    CudaFunction(SOURCE, "rt2_probe_lane_gather_chain", "ppiip"),
    "scripts/probe_lut.py:69")
SUBLANE_GATHER_SAMEY = kernel(
    "sublane_gather_samey",
    CudaFunction(SOURCE, "rt2_probe_sublane_gather_samey", "ppip"),
    "scripts/probe_lut.py:101")
LUT1024_CHAIN = kernel(
    "lut1024_chain", CudaFunction(SOURCE, "rt2_probe_lut1024_chain", "ppiip"),
    "scripts/probe_lut.py:155")
LUT_ROW_FETCH = kernel(
    "lut_row_fetch", CudaFunction(SOURCE, "rt2_probe_lut_row_fetch", "pipip"),
    "scripts/probe_lut.py:196")
SCALAR_TREELET_SELECT = kernel(
    "scalar_treelet_select",
    CudaFunction(SOURCE, "rt2_probe_scalar_treelet_select", "piipip"),
    "scripts/probe_lut.py:238")
MXU_LEAF_DENSE = kernel(
    "mxu_leaf_dense",
    CudaFunction(SOURCE, "rt2_probe_mxu_leaf_dense", "ppiiiipp"),
    "scripts/probe_lut.py:276")
MXU_LEAF_DENSE_MMA = kernel(
    "mxu_leaf_dense_mma",
    CudaFunction(SOURCE, "rt2_probe_mxu_leaf_dense_mma", "ppiiipp"),
    "scripts/probe_lut.py:276")
BIG_BODY = kernel("big_body_compile",
                  CudaFunction(SOURCE, "rt2_probe_big_body", "pipippp"),
                  "scripts/probe_lut.py:323")
#: shared memory a block may use (227 KB on Hopper)
SMEM_LIMIT = 232448


def _check_block(name, x, dev, rows=SUB, dtype=torch.float32):
    check_tensor(name, x, dtype, (rows, COLS), dev)


# ------------------------------------------------------ the two-level LUT --
def lut1024(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``_lut1024`` (``probe_lut.py:113``): out[s, l] = tab[hi, lo[hi, l]]
    with hi = idx[s, l] >> 7, lo = idx & 127 (the second gather reads the
    ``lo`` of lane (hi, l)). tab (8, 128), idx (8, 128) int64."""
    g = tab.gather(1, idx & 127)
    return g.gather(0, idx >> 7)


def lut1024_sel(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``_lut1024_sel`` (``probe_lut.py:122``): the sublane level as 8
    compare-selects; the same values as ``lut1024``."""
    g = tab.gather(1, idx & 127)
    hi, out = idx >> 7, torch.zeros_like(g)
    for s in range(SUB):
        out = torch.where(hi == s, g[s:s + 1].expand_as(g), out)
    return out


def lut_columns(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``lut1024`` of every (8, 128) block of cols (C, 8, 128) at once:
    (C, 8, 128)."""
    hi = idx >> 7
    lo = (idx & 127).gather(0, hi)          # lo of lane (hi, l)
    C = cols.shape[0]
    flat = cols.reshape(C, SUB * COLS)
    at = (hi * COLS + lo).reshape(1, -1).expand(C, -1)
    return flat.gather(1, at).reshape(C, SUB, COLS)


# ---------------------------------------------------- lane_gather_chain --
def lane_gather_chain(tab, idx0, *, steps: int = 512):
    """``steps`` fetches ``v = tab[s, idx[s, l]] % 128`` (per-sublane
    128-entry tables): tab (rows, 128) f32, idx0 (rows, 128) int32, rows a
    multiple of 8. Returns the final idx (rows, 128) f32."""
    if not on_cuda(tab, idx0):
        return lane_gather_chain_plain(tab, idx0, steps=steps)
    dev, rows = tab.device, tab.shape[0]
    if rows % SUB:
        raise ValueError(f"lane_gather_chain: {rows} rows, not a multiple "
                         f"of {SUB}")
    _check_block("tab", tab, dev, rows)
    _check_block("idx0", idx0, dev, rows, torch.int32)
    out = torch.empty((rows, COLS), dtype=torch.float32, device=dev)
    LANE_GATHER_CHAIN.launch(tab, idx0, rows, steps, out)
    return out


def lane_gather_chain_plain(tab, idx0, *, steps: int = 512):
    idx = idx0.long()
    for _ in range(steps):
        idx = tab.gather(1, idx).long() % 128
    return idx.float()


# ------------------------------------------------- sublane_gather_samey --
def sublane_gather_samey(tab, idx0, *, steps: int = 512):
    """``steps`` fetches ``v = tab[idx[s, l], l] % 8``: tab (8, 128) f32,
    idx0 (8, 128) int32 in [0, 8). Returns the final idx (8, 128) f32."""
    if not on_cuda(tab, idx0):
        return sublane_gather_samey_plain(tab, idx0, steps=steps)
    dev = tab.device
    _check_block("tab", tab, dev)
    _check_block("idx0", idx0, dev, dtype=torch.int32)
    out = torch.empty((SUB, COLS), dtype=torch.float32, device=dev)
    SUBLANE_GATHER_SAMEY.launch(tab, idx0, steps, out)
    return out


def sublane_gather_samey_plain(tab, idx0, *, steps: int = 512):
    idx = idx0.long()
    for _ in range(steps):
        idx = tab.gather(0, idx).long() % 8
    return idx.float()


# -------------------------------------------------------- lut1024_chain --
def lut1024_chain(tab, idx0, *, steps: int = 512, select: bool = False):
    """``steps`` two-level LUT fetches ``idx = int(lut1024(tab, idx)) %
    1024``: tab (8, 128) f32, idx0 (8, 128) int32 in [0, 1024). ``select``
    takes the compare-select form. Returns the final idx (8, 128) f32."""
    if not on_cuda(tab, idx0):
        return lut1024_chain_plain(tab, idx0, steps=steps, select=select)
    dev = tab.device
    _check_block("tab", tab, dev)
    _check_block("idx0", idx0, dev, dtype=torch.int32)
    out = torch.empty((SUB, COLS), dtype=torch.float32, device=dev)
    LUT1024_CHAIN.launch(tab, idx0, steps, int(select), out)
    return out


def lut1024_chain_plain(tab, idx0, *, steps: int = 512,
                        select: bool = False):
    lut = lut1024_sel if select else lut1024
    idx = idx0.long()
    for _ in range(steps):
        idx = lut(tab, idx).long() % 1024
    return idx.float()


# -------------------------------------------------------- lut_row_fetch --
def lut_row_fetch(tab, idx0, *, steps: int = 128):
    """``steps`` steps of C two-level fetches summed, the next idx =
    (int(column 0) % 1024 + int(sum)) % 1024: tab (C*8, 128) f32, idx0
    (8, 128) int32. Returns the final idx (8, 128) f32."""
    if not on_cuda(tab, idx0):
        return lut_row_fetch_plain(tab, idx0, steps=steps)
    dev, C = tab.device, tab.shape[0] // SUB
    _check_block("tab", tab, dev, C * SUB)
    _check_block("idx0", idx0, dev, dtype=torch.int32)
    if (C + 1) * SUB * COLS * 4 > SMEM_LIMIT:
        raise ValueError(f"lut_row_fetch: {C} columns do not fit in shared "
                         f"memory")
    out = torch.empty((SUB, COLS), dtype=torch.float32, device=dev)
    LUT_ROW_FETCH.launch(tab, C, idx0, steps, out)
    return out


def lut_row_fetch_plain(tab, idx0, *, steps: int = 128):
    """Column sums of integers below 2^24 are exact in float32 in any
    order, so the C fetches are summed at once."""
    cols = tab.view(-1, SUB, COLS)
    idx = idx0.long()
    for _ in range(steps):
        v = lut_columns(cols, idx)
        nxt = v[0].long() % 1024
        idx = (nxt + v.sum(0).long()) % 1024
    return idx.float()


# ------------------------------------------------ scalar_treelet_select --
def scalar_treelet_select(tab, idx0, *, steps: int = 128, C: int = 12):
    """``steps`` steps: tid = min(idx) >> 10 over the block, that
    treelet's C columns fetched through the two-level LUT and summed,
    idx = (idx + int(sum) + 1) % (n_treelets * 1024): tab
    (n_treelets*C*8, 128) f32, idx0 (8, 128) int32. Returns the final idx
    (8, 128) f32."""
    if not on_cuda(tab, idx0):
        return scalar_treelet_select_plain(tab, idx0, steps=steps, C=C)
    dev, n = tab.device, tab.shape[0] // (C * SUB)
    _check_block("tab", tab, dev, n * C * SUB)
    _check_block("idx0", idx0, dev, dtype=torch.int32)
    out = torch.empty((SUB, COLS), dtype=torch.float32, device=dev)
    SCALAR_TREELET_SELECT.launch(tab, C, n, idx0, steps, out)
    return out


def scalar_treelet_select_plain(tab, idx0, *, steps: int = 128, C: int = 12):
    treelets = tab.view(-1, C, SUB, COLS)
    modulus = treelets.shape[0] * 1024
    idx = idx0.long()
    for _ in range(steps):
        cols = treelets[idx.min() >> 10]
        acc = lut_columns(cols, idx & 1023).sum(0)
        idx = (idx + acc.long() + 1) % modulus
    return idx.float()


# ------------------------------------------------------- mxu_leaf_dense --
#: the tensor-core form's gate against the plain version: relative
#: tolerance of the output and of the float64 column sums on lanes finite
#: in both (one bfloat16 ulp is 3.9e-3 to 7.8e-3 of the value: a sum taken
#: in another order can round one step's operand the other way), and the
#: share of lanes (rays) whose overflow agrees
MMA_RTOL = 1e-2
MMA_MASK_SHARE = 0.999


def mxu_leaf_dense(rays, tris, *, steps: int = 64, form: str = "simt"):
    """``steps`` steps of acc = (dot(rays + acc, tris))[:, :16] * 0.5 in the
    inputs' type (float32 or bfloat16; float32 sums over the 16 features):
    rays (B, 16), tris (16, T).

    ``form="simt"``: the sums run in feature order. Returns (the probe's
    output (B, 16) f32, the sum of the bit patterns of every product column
    of every step (B,) int64). On the card float32 takes the register tile
    (2 rays a thread), bfloat16 the SIMT kernel.

    ``form="mma"`` (bfloat16, T a multiple of 8): on the card the products
    run on the tensor cores, which sum in their own order. Returns (the output (B, 16) f32, the
    float64 sum of every product column of every step (B,)); held to
    ``mma_gate``, not bit for bit."""
    if form not in ("simt", "mma"):
        raise ValueError(f"mxu_leaf_dense: form {form!r}, not simt or mma")
    if not on_cuda(rays, tris):
        return mxu_leaf_dense_plain(rays, tris, steps=steps, form=form)
    dev, dt, B, T = rays.device, rays.dtype, rays.shape[0], tris.shape[1]
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mxu_leaf_dense: float32 or bfloat16, got {dt}")
    check_tensor("rays", rays, dt, (B, FEAT), dev)
    check_tensor("tris", tris, dt, (FEAT, T), dev)
    out = torch.empty((B, FEAT), dtype=torch.float32, device=dev)
    if form == "mma":
        if dt != torch.bfloat16 or T < FEAT or T % 8:
            raise ValueError(f"mxu_leaf_dense: the tensor-core form takes "
                             f"bfloat16 and T a multiple of 8 from {FEAT}, "
                             f"got {dt}, T = {T}")
        sums = torch.zeros(B, dtype=torch.float64, device=dev)
        MXU_LEAF_DENSE_MMA.launch(rays, tris, B, T, steps, out, sums)
        return out, sums
    if T < FEAT or FEAT * (T + 3) * 4 + 8192 > SMEM_LIMIT:
        raise ValueError(f"mxu_leaf_dense: {T} triangles outside "
                         f"[{FEAT}, shared memory]")
    bits = torch.zeros(B, dtype=torch.int64, device=dev)
    MXU_LEAF_DENSE.launch(rays, tris, B, T, int(dt == torch.bfloat16), steps,
                          out, bits)
    return out, bits


def mxu_leaf_dense_plain(rays, tris, *, steps: int = 64, form: str = "simt"):
    """The plain PyTorch version (any device): sums in feature order. With
    ``form="mma"`` the second output is the float64 column sum instead of
    the bit checksum."""
    dt = rays.dtype
    tf = tris.float()
    acc = torch.zeros_like(rays)
    check = torch.zeros(rays.shape[0], device=rays.device,
                        dtype=torch.float64 if form == "mma" else torch.int64)
    for _ in range(steps):
        x = (rays + acc).float()
        p = x[:, :1] * tf[:1]
        for f in range(1, FEAT):
            p = p + x[:, f:f + 1] * tf[f:f + 1]
        check += p.double().sum(1) if form == "mma" else bit_sum(p)
        acc = p[:, :FEAT].to(dt) * 0.5
    return acc.float(), check


def mma_gate(out, ref) -> dict:
    """The tensor-core form (output, column sums) against the plain
    version's: the largest relative error of each over the lanes (rays)
    finite in both, and the share of lanes (rays) whose finiteness agrees;
    ``ok`` if both errors are within ``MMA_RTOL`` and both shares at least
    ``MMA_MASK_SHARE``."""
    res = {}
    for name, a, b in (("out", out[0], ref[0]), ("col_sum", out[1], ref[1])):
        a, b = a.double(), b.double()
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        both = fa & fb
        rel = ((a - b).abs() / b.abs().clamp_min(1e-300))[both]
        res[f"{name}_max_rel_err"] = float(rel.max()) if rel.numel() else 0.0
        res[f"{name}_mask_share"] = float((fa == fb).double().mean())
        res[f"{name}_finite_share"] = float(both.double().mean())
        if name == "out":
            err = (a - b).abs()[both]
            res["max_abs_err"] = float(err.max()) if err.numel() else 0.0
    res["rtol"], res["mask_share_needed"] = MMA_RTOL, MMA_MASK_SHARE
    res["ok"] = all(res[f"{n}_max_rel_err"] <= MMA_RTOL
                    and res[f"{n}_mask_share"] >= MMA_MASK_SHARE
                    for n in ("out", "col_sum"))
    return res


# ----------------------------------------------------- big_body_compile --
def big_body(tab, idx0, *, steps: int = 64):
    """``big_body_compile``: ``steps`` steps of C two-level column fetches
    and a slab-sized min/max over column pairs (0, 1) .. (C-4, C-3): tab
    (C*8, 128) f32, idx0 (8, 128) int32. Returns (the probe's output (8,
    128) f32 = best + idx, the final idx (8, 128) int32, the sum of every
    fetched column over all steps (8, 128) int32)."""
    if not on_cuda(tab, idx0):
        return big_body_plain(tab, idx0, steps=steps)
    dev, C = tab.device, tab.shape[0] // SUB
    _check_block("tab", tab, dev, C * SUB)
    _check_block("idx0", idx0, dev, dtype=torch.int32)
    if C < 2 or (C + 1) * SUB * COLS * 4 > SMEM_LIMIT:
        raise ValueError(f"big_body: {C} columns outside [2, shared memory]")
    out = torch.empty((SUB, COLS), dtype=torch.float32, device=dev)
    idx = torch.empty((SUB, COLS), dtype=torch.int32, device=dev)
    sums = torch.empty((SUB, COLS), dtype=torch.int32, device=dev)
    BIG_BODY.launch(tab, C, idx0, steps, out, idx, sums)
    return out, idx, sums


def big_body_plain(tab, idx0, *, steps: int = 64):
    cols_tab = tab.view(-1, SUB, COLS)
    C = cols_tab.shape[0]
    idx = idx0.long()
    best = torch.zeros((SUB, COLS), dtype=torch.float32, device=tab.device)
    sums = torch.zeros_like(idx)
    for _ in range(steps):
        cols = lut_columns(cols_tab, idx)
        sums += cols.long().sum(0)
        tmin = torch.full_like(best, -3e38)
        tmax = torch.full_like(best, 3e38)
        for c in range(0, C - 2, 2):
            t1 = (cols[c] - best) * 0.5
            t2 = (cols[c + 1] - best) * 0.5
            tmin = torch.maximum(tmin, torch.minimum(t1, t2))
            tmax = torch.minimum(tmax, torch.maximum(t1, t2))
        hit = (tmax >= tmin).float()
        idx = (cols[0].long() + idx) % 1024
        best = best + hit * 0.25
    return best + idx.float(), idx.int(), sums.int()


# ================================================================= runs ==
def _block_inputs(ctx, rows: int, high: int, idx_high: int):
    rng = ctx.rng()
    tab = ctx.tensor(rng.integers(0, high, (rows, COLS)).astype(np.float32))
    idx0 = ctx.tensor(rng.integers(0, idx_high, (SUB, COLS))
                      .astype(np.int32))
    return tab, idx0


@probe("lane_gather_chain")
def p_lane_gather_chain(ctx):
    steps = 512
    for rows in ctx.sizes((8, 32, 128)):
        rng = ctx.rng()
        B = rows * COLS
        tab = ctx.tensor(rng.integers(0, 128, (rows, COLS)).astype(np.float32))
        idx0 = ctx.tensor(rng.integers(0, 128, (rows, COLS)).astype(np.int32))
        measure(ctx, "lane_gather_chain", dict(B=B),
                functools.partial(lane_gather_chain, steps=steps),
                (tab, idx0),
                lambda t: dict(us_per_step=t / steps * 1e6,
                               ns_per_vreg=t / steps / max(rows // 8, 1)
                               * 1e9,
                               gfetch_per_s=B * steps / t / 1e9),
                plain=functools.partial(lane_gather_chain_plain,
                                        steps=steps),
                ops=B * steps, nbytes=nbytes(tab, idx0) + B * 4,
                kernel="lane_gather_chain", iters=5)


@probe("sublane_gather_samey")
def p_sublane_gather_samey(ctx):
    B, steps = 1024, 512
    tab, idx0 = _block_inputs(ctx, SUB, 8, 8)
    measure(ctx, "sublane_gather_samey", dict(B=B),
            functools.partial(sublane_gather_samey, steps=steps),
            (tab, idx0),
            lambda t: dict(us_per_step=t / steps * 1e6,
                           gfetch_per_s=B * steps / t / 1e9),
            plain=functools.partial(sublane_gather_samey_plain, steps=steps),
            ops=B * steps, nbytes=nbytes(tab, idx0) + B * 4,
            kernel="sublane_gather_samey", iters=5)


@probe("lut1024_chain")
def p_lut1024_chain(ctx):
    steps = 512
    for variant in ("gather", "select"):
        tab, idx0 = _block_inputs(ctx, SUB, 1024, 1024)
        select = variant == "select"
        measure(ctx, "lut1024_chain", dict(variant=variant),
                functools.partial(lut1024_chain, steps=steps, select=select),
                (tab, idx0),
                lambda t: dict(us_per_step=t / steps * 1e6,
                               gfetch_per_s=1024 * steps / t / 1e9),
                plain=functools.partial(lut1024_chain_plain, steps=steps,
                                        select=select),
                ops=1024 * steps * 2, nbytes=nbytes(tab, idx0) + 4096,
                kernel="lut1024_chain", iters=5)


@probe("lut_row_fetch")
def p_lut_row_fetch(ctx):
    steps = 128
    for C in ctx.sizes((8, 26, 50)):
        tab, idx0 = _block_inputs(ctx, C * SUB, 1024, 1024)
        measure(ctx, "lut_row_fetch", dict(C=C),
                functools.partial(lut_row_fetch, steps=steps), (tab, idx0),
                lambda t, C=C: dict(us_per_step=t / steps * 1e6,
                                    us_per_col=t / steps / C * 1e6),
                plain=functools.partial(lut_row_fetch_plain, steps=steps),
                ops=1024 * steps * C * 3, nbytes=nbytes(tab, idx0) + 4096,
                kernel="lut_row_fetch", iters=5)


@probe("scalar_treelet_select")
def p_scalar_treelet_select(ctx):
    steps, C, NT = 128, 12, 16
    tab, idx0 = _block_inputs(ctx, NT * C * SUB, 3, NT * 1024)
    measure(ctx, "scalar_treelet_select", dict(C=C, n_treelets=NT),
            functools.partial(scalar_treelet_select, steps=steps, C=C),
            (tab, idx0), lambda t: dict(us_per_step=t / steps * 1e6),
            plain=functools.partial(scalar_treelet_select_plain, steps=steps,
                                    C=C),
            ops=1024 * steps * (C * 3 + 2), nbytes=nbytes(tab, idx0) + 4096,
            kernel="scalar_treelet_select", iters=5)


def _chain_step_ms(ctx, dt, form: str) -> float:
    """Device milliseconds of one dependent step of one ray tile alone on
    the card (T = 16, one block: one warp in the tensor-core form): the
    slope of the kernel-only time between 64 and 2112 steps."""
    rng = ctx.rng()
    B = 16 if form == "mma" else 1
    rays = ctx.tensor(rng.random((B, FEAT)).astype(np.float32), dt)
    tris = ctx.tensor(rng.random((FEAT, FEAT)).astype(np.float32), dt)
    t = [graph_ms(lambda: mxu_leaf_dense(rays, tris, steps=n, form=form),
                  ctx.device, launches=4, replays=3) for n in (64, 2112)]
    return (t[1] - t[0]) / 2048


#: steps of the overflow lines: the chain grows about fourfold a step on
#: inputs in [0, 1) and leaves float32 soon after the probe's 64 steps. On
#: the probe's seeded inputs a few rays are still finite at 65 steps (T =
#: 128) and at 70 (T = 512), the border the mask share is about; at 72 none
OVERFLOW_STEPS = (65, 70, 72)


def _overflow_gate(ctx, rays, tris, T: int) -> None:
    """The tensor-core form against the plain version where the chain
    overflows: one untimed line per step count of ``OVERFLOW_STEPS`` with the
    gate's numbers (the overflow masks must agree on ``MMA_MASK_SHARE`` of
    the rays). Raises ``ProbeMismatch`` outside the gate."""
    for steps in OVERFLOW_STEPS:
        g = mma_gate(mxu_leaf_dense(rays, tris, steps=steps, form="mma"),
                     mxu_leaf_dense_plain(rays, tris, steps=steps,
                                          form="mma"))
        emit("mxu_leaf_dense_overflow", dtype="bfloat16", form="mma", T=T,
             steps=steps, gate=g, card=ctx.card)
        if not g["ok"]:
            raise ProbeMismatch(f"mxu_leaf_dense mma T={T} steps={steps}: "
                                f"outside its gate {g}")


@probe("mxu_leaf_dense")
def p_mxu_leaf_dense(ctx):
    """One line per form and size: float32 (register tile), bfloat16 SIMT,
    bfloat16 on the tensor cores, each with its operation bound, the
    chain's latency floor (``steps`` x one dependent step of one ray tile
    alone; not under ``ctx.smoke``). Both sizes run under ``ctx.smoke`` too:
    they are the two the tensor-core form's gate is stated for."""
    steps, B = 64, 1024
    cuda = ctx.device.type == "cuda"
    forms = (("float32", torch.float32, "simt", PEAK_FLOPS, PEAK_FLOPS_NOFMA),
             ("bfloat16", torch.bfloat16, "simt", PEAK_BF16_FLOPS,
              PEAK_FLOPS_NOFMA),
             ("bfloat16", torch.bfloat16, "mma", PEAK_BF16_FLOPS,
              PEAK_BF16_FLOPS))
    for name, dt, form, peak, nofma in forms:
        step_ms = _chain_step_ms(ctx, dt, form) \
            if cuda and not ctx.smoke else None
        for T in (128, 512):
            rng = ctx.rng()
            rays = ctx.tensor(rng.random((B, FEAT)).astype(np.float32), dt)
            tris = ctx.tensor(rng.random((FEAT, T)).astype(np.float32), dt)

            def extra(t, T=T, step_ms=step_ms):
                if not cuda:
                    return {}
                ms = t["kernel_only_ms"]
                floor = {} if step_ms is None else dict(
                    chain_floor_ms=steps * step_ms,
                    chain_floor_share=steps * step_ms / ms)
                return dict(
                    floor, g_raytri_per_s_kernel_only=B * T * steps / ms / 1e6)

            measure(ctx, "mxu_leaf_dense", dict(dtype=name, form=form, T=T),
                    functools.partial(mxu_leaf_dense, steps=steps, form=form),
                    (rays, tris),
                    lambda t, T=T: dict(
                        us_per_step=t / steps * 1e6,
                        g_raytri_per_s=B * T * steps / t / 1e9),
                    plain=functools.partial(mxu_leaf_dense_plain,
                                            steps=steps, form=form),
                    ops=2 * B * T * FEAT * steps,
                    nbytes=nbytes(rays, tris) + B * (FEAT * 4 + 8),
                    kernel="mxu_leaf_dense_mma" if form == "mma"
                    else "mxu_leaf_dense", iters=5, peak_flops=peak,
                    nofma_flops=nofma, kernel_only=True,
                    gate=mma_gate if form == "mma" else None, extra=extra)
            if form == "mma" and cuda:
                _overflow_gate(ctx, rays, tris, T)


@probe("big_body_compile")
def p_big_body(ctx):
    steps, C = 64, 50
    tab, idx0 = _block_inputs(ctx, C * SUB, 1024, 1024)
    measure(ctx, "big_body_compile", dict(C=C),
            functools.partial(big_body, steps=steps), (tab, idx0),
            lambda t: dict(us_per_step=t / steps * 1e6),
            plain=functools.partial(big_body_plain, steps=steps),
            ops=1024 * steps * (C + 24 * 6 + 4),
            nbytes=nbytes(tab, idx0) + 1024 * 12, kernel="big_body_compile",
            iters=5)
