"""What the Hopper probes share: the counterparts of the TPU probe scripts'
``emit``, ``bench``, ``guard`` and ``probe`` (``scripts/probe_r2.py:26-86``),
and ``measure``, which runs one probe at one size and prints its line.

Each probe function (``trav.trav``, ``r2.onehot_loop``, ...) takes its
inputs as tensors and returns its outputs: on a CUDA tensor it launches its
hand-written kernel (``csrc/probe_*.cu``), on a CPU tensor it runs the plain
PyTorch version beside it, and on any other device it raises. A line of
output carries the script's own keys, computed as the script computes them
from the time of one call on the host clock (after
``torch.cuda.synchronize()``: the counterpart of the scripts' wall time,
dispatch included), and besides: ``device_ms`` (CUDA events over the same
calls: for a kernel of a few microseconds that is the host's cost per call,
the card idling between launches), ``host_us`` (the host clock per call
while the calls are queued, before any synchronisation), ``kernel_only_ms``
where asked for (the same calls captured once into a CUDA graph and
replayed, CUDA events around the replays: no Python, no wrapper, no
allocator between the launches), ``plain_ms`` (one warm call of the plain
version), ``library_ms`` / ``library_host_us`` / ``library_kernel_only_ms``
(one PyTorch call computing the same function, where there is one, timed
the same three ways),
``bound_ms`` / ``bound_by`` (the larger of the counted operations over the
card's 67 TFLOP/s float32 peak and the bytes over its 3.35 TB/s),
``bound_nofma_ms`` (the same with the operations over half that peak: every
kernel here is compiled with ``--fmad=false``, so a multiply and an add are
two instructions and half the peak is the ceiling it can approach),
``max_abs_err`` / ``plain_equal`` (kernel against plain version on the same
inputs, every output exact; a kernel that cannot be bit-equal states its
``gate`` instead) and ``card`` (``nvidia-smi``'s name and power
limit). On the CPU the device keys are null: nothing there measures a card.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from ray_tracer_2_tpu_torch.kernels.cuda_build import PKG

CSRC = PKG / "csrc"
#: the card's published peaks (H100 SXM at 700 W): float32 outside the
#: tensor cores, bfloat16 on the tensor cores (dense), device memory
PEAK_FLOPS = 67e12
#: what float32 code compiled without contraction (``--fmad=false``: one
#: operation an instruction) can execute at most
PEAK_FLOPS_NOFMA = PEAK_FLOPS / 2
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: (name, runner) in the order the scripts run them; ``probe`` adds to it
PROBES: list = []
#: the probes that run PyTorch calls only (the scripts' XLA probes)
LIBRARY_PROBES: set = set()
#: kernel name -> (CudaFunction, the TPU kernel's ``file:line``)
KERNELS: dict = {}


class ProbeMismatch(RuntimeError):
    """A kernel's outputs differ from its plain version's."""


def probe(name: str, library: bool = False):
    """Register ``fn(ctx)`` as the probe ``name`` (as ``probe_r2.probe``);
    ``library``: it runs PyTorch calls only, no kernel of this package."""
    def deco(fn):
        PROBES.append((name, fn))
        if library:
            LIBRARY_PROBES.add(name)
        return fn
    return deco


def kernel_probes() -> list:
    """The names of the probes that launch this package's kernels."""
    return [n for n, _ in PROBES if n not in LIBRARY_PROBES]


def kernel(name: str, wrapper, replaces: str):
    """Name a probe kernel's wrapper and the TPU kernel it replaces."""
    KERNELS[name] = (wrapper, replaces)
    return wrapper


def emit(probe: str, **kw) -> None:
    print(json.dumps({"probe": probe, **kw}), flush=True)


def guard(name: str, fn, ctx) -> bool:
    """Run ``fn(ctx)``; on an exception print ``{"probe": name, "error":
    ...}`` and the traceback, and return False (the scripts' ``guard``:
    the remaining probes still run)."""
    try:
        fn(ctx)
        return True
    except Exception as e:  # noqa: BLE001 - reported, and the run fails
        emit(name, error=f"{type(e).__name__}: {e}"[:300], card=ctx.card)
        traceback.print_exc(file=sys.stderr)
        return False


def card_name(device: torch.device) -> str:
    """``name, power limit`` of the card as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    lines = res.stdout.strip().splitlines()
    return lines[device.index or 0] if len(lines) > (device.index or 0) \
        else lines[0]


def on_cuda(*tensors) -> bool:
    """True for CUDA tensors (the kernel), False for CPU tensors (the plain
    version); raises for any other device or a mix."""
    devs = {t.device.type for t in tensors}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        return False
    raise ValueError(f"no implementation for devices {sorted(devs)}")


@dataclasses.dataclass
class Ctx:
    """One run of the probes: the device, the seed the inputs come from,
    ``smoke`` (only the first of each script's sizes and no measurement
    beyond a line's own times), the card's name and
    the lines printed so far."""
    device: torch.device
    seed: int = 0
    smoke: bool = False
    card: str = "cpu"
    records: list = dataclasses.field(default_factory=list)

    def sizes(self, sizes):
        sizes = list(sizes)
        return sizes[:1] if self.smoke else sizes

    def rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)

    def tensor(self, a, dtype: torch.dtype | None = None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return t if dtype is None else t.to(dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(fn, device: torch.device, iters: int = 10,
          warmup: int = 2, kernel_only: bool = False) -> dict:
    """Time ``fn()`` over ``iters`` calls after ``warmup``: ``wall_s``, the
    host clock per call between two synchronisations; ``host_us``, the host
    clock per call until the last call returned (queued, not finished);
    ``device_ms``, CUDA events around the same calls (None on the CPU);
    with ``kernel_only`` on the card, ``kernel_only_ms`` (``graph_ms``)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    start = end = None
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if start is not None:
        start.record()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    if end is not None:
        end.record()
    _sync(device)
    wall = (time.perf_counter() - t0) / iters
    return dict(wall_s=wall, host_us=(t1 - t0) / iters * 1e6,
                device_ms=None if start is None
                else start.elapsed_time(end) / iters,
                kernel_only_ms=graph_ms(fn, device)
                if kernel_only and device.type == "cuda" else None)


def graph_ms(fn, device: torch.device, launches: int = 20,
             replays: int = 10) -> float:
    """Milliseconds of one ``fn()`` on the card with the host taken out:
    ``launches`` calls are captured once into a ``torch.cuda.CUDAGraph``
    (their kernels, and the fills of outputs they allocate) and the graph
    is replayed ``replays`` times between two CUDA events. ``fn`` must not
    synchronise or read a result back."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):       # warm the allocator off the
        fn()                            # default stream, as capture asks
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / (launches * replays)


def timed_once(fn, device: torch.device):
    """(``fn()``, milliseconds of that one call on the host clock between
    two synchronisations)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def bound(ops: float, nbytes: float, peak_flops: float = PEAK_FLOPS,
          nofma_flops: float = PEAK_FLOPS_NOFMA) -> dict:
    """The least time the card could take: the larger of ``ops`` over the
    peak for their type (float32 unless given) and ``nbytes`` over the
    memory rate. ``bound_nofma_ms`` is the same with ``ops`` over
    ``nofma_flops``, the rate code compiled without contraction can run
    at (for a tensor-core product, whose multiply-adds are fused in the
    unit, pass its peak)."""
    t_ops = ops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_nofma_ms=max(ops / nofma_flops * 1e3, t_bytes),
                ops=float(ops), bytes=float(nbytes))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def as_tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def compare(out, ref) -> tuple[bool, float]:
    """(every output bit-equal, the largest absolute difference of the
    float outputs; infinities of one sign count as equal)."""
    out, ref = as_tuple(out), as_tuple(ref)
    if len(out) != len(ref):
        return False, float("inf")
    equal, err = True, 0.0
    for a, b in zip(out, ref):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, float("inf")
        if a.is_floating_point():
            a, b = a.float(), b.float()
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            if not bool(same.all()):
                equal = False
                err = max(err, float((a - b).abs()[~same].max()))
        elif not torch.equal(a, b):
            equal = False
            err = max(err, float((a.double() - b.double()).abs().max()))
    return equal, err


def measure(ctx: Ctx, name: str, size: dict, fn, args: tuple, keys, *,
            plain=None, library=None, ops: float = 0.0, nbytes: float = 0.0,
            kernel: str | None = None, iters: int = 10, warmup: int = 2,
            peak_flops: float = PEAK_FLOPS,
            nofma_flops: float = PEAK_FLOPS_NOFMA, kernel_only: bool = False,
            gate=None, extra=None) -> dict:
    """Run ``fn(*args)`` once, hold it against ``plain(*args)`` (on the
    card), time it with ``bench``, time ``plain`` once after a warm-up call
    and ``library`` with ``bench``,
    print the line and keep it in ``ctx.records``. ``keys(seconds)`` gives
    the script's keys from the host time of one call. The kernel must be
    bit-equal to its plain version, unless ``gate(out, ref)`` is given: it
    returns the gate's numbers, ``ok`` and ``max_abs_err`` among them, and
    decides instead. ``extra`` is a dict of further keys or a function of
    the timing dict giving them. Raises ``ProbeMismatch`` after printing if
    the kernel and its plain version differ."""
    dev = ctx.device
    out = fn(*args)
    _sync(dev)
    equal = err = plain_ms = gated = None
    if plain is not None:
        ref = plain(*args)              # also its warm-up
        plain_ms = timed_once(lambda: plain(*args), dev)[1]
        if dev.type == "cuda" and gate is not None:
            gated = gate(out, ref)
            err = gated["max_abs_err"]
        elif dev.type == "cuda":
            equal, err = compare(out, ref)
    t = bench(lambda: fn(*args), dev, iters=iters, warmup=warmup,
              kernel_only=kernel_only)
    lib = dict(device_ms=None, host_us=None, kernel_only_ms=None)
    if library is not None and dev.type == "cuda":
        lib = bench(lambda: library(*args), dev, iters=iters, warmup=warmup,
                    kernel_only=kernel_only)
    rec = dict(probe=name, **size, **keys(t["wall_s"]),
               wall_ms=t["wall_s"] * 1e3, device_ms=t["device_ms"],
               host_us=t["host_us"], kernel_only_ms=t["kernel_only_ms"],
               plain_ms=plain_ms, library_ms=lib["device_ms"],
               library_host_us=lib["host_us"],
               library_kernel_only_ms=lib["kernel_only_ms"],
               **bound(ops, nbytes, peak_flops, nofma_flops),
               max_abs_err=err, plain_equal=equal, gate=gated,
               kernel=kernel, card=ctx.card,
               **(extra(t) if callable(extra) else extra or {}))
    emit(**rec)
    ctx.records.append(rec)
    if equal is False or (gated is not None and not gated["ok"]):
        raise ProbeMismatch(f"{name} {size}: kernel differs from its plain "
                            f"version (max abs err {err}, gate {gated})")
    return rec


def run(ctx: Ctx, names=()) -> bool:
    """Run the registered probes named in ``names`` (all if empty) in
    order; True if every one ran and matched its plain version."""
    want = set(names)
    unknown = want - {n for n, _ in PROBES}
    if unknown:
        raise ValueError(f"unknown probes {sorted(unknown)}; known: "
                         f"{[n for n, _ in PROBES]}")
    ok = True
    for name, fn in PROBES:
        if want and name not in want:
            continue
        t0 = time.perf_counter()
        ok &= guard(name, fn, ctx)
        emit("done", name=name, wall_s=time.perf_counter() - t0,
             card=ctx.card)
    return ok
