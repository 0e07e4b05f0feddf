"""One run of one cell: set-up, the measured window through
``Engine.update``, the traced window's per-layer readings, and the
comparison with the reference that decides ``correct``.

The window is a closed loop: each ``Engine.update`` starts when the last
returned, with the mix's fixed ``dt`` (and, in a moving mix, the seeded
mouse delta given to the controller first, as the viewer's ``/input``
does; ``traffic.Frames``). ``update`` dispatches its frame, then waits for
the frame before it, so the card holds up to two frames; the window closes
with a ``synchronize`` on every card, so every frame started in it has
finished when it is read.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from rtbench import manifest, traffic

#: pixels of a still cell whose every frame the reference traces
STILL_PIXELS = 256
#: what a run loads that the port must not: the JAX stack and the JAX
#: package, compared by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracer_2_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def span(name: str, fn):
    """``fn`` inside a host span of the profiler's timeline, named
    ``rtbench.<name>``: the benchmark's spans around the program's calls,
    from outside it."""
    import torch

    def wrapped(*a, **kw):
        with torch.profiler.record_function("rtbench." + name):
            return fn(*a, **kw)
    return wrapped


def _devices(eng) -> list:
    mesh = eng.renderer.mesh
    return list(mesh.distinct) if mesh is not None else [eng.device]


def _sample_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0x5EED])
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels), replace=False))


def drive(cell: dict, seed: int, seconds: float, trace: bool,
          device: str = "cuda", size: tuple | None = None,
          root: Path = manifest.ROOT, hook=None) -> tuple[dict, dict]:
    """Set up the cell, run its window and hand back the run's record
    (``drive_inputs``). ``size`` overrides the 1920x1080 frame (tests on the
    CPU); ``hook``, called with the engine before the window, lets a test
    break the path underneath. Returns (the record, the configuration's
    inputs)."""
    man = manifest.load(root)
    spec = manifest.config(man, cell["config"], root)
    mix = traffic.load(cell["traffic"], root / "rtbench")
    inputs = manifest.builder(cell["config"], root).inputs(spec, seed)
    run = drive_inputs(inputs, mix, seed, seconds, trace, device, size,
                       hook)
    return dict(run, cell=cell["name"], config=cell["config"]), inputs


def drive_inputs(inputs: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, device: str = "cuda",
                 size: tuple | None = None, hook=None) -> dict:
    """The program's ``Engine`` on ``inputs`` under the traffic ``mix``:
    its warm frames, then the window. Returns the run's record: the
    timings, the trace, and what the comparison needs (the program's values
    at the compared pixels, the last frame's segments, the deltas sent)."""
    import torch
    from rtbench import program

    eng = program.engine(inputs, device, traffic.params(mix, size))
    if hook is not None:
        hook(eng)
    frames = traffic.Frames(mix, seed, eng)
    segments = []

    def frame():
        frames.step()
        segments.append(eng.renderer.last_segments)

    for _ in range(int(mix["warm_frames"])):
        frame()
    eng.renderer.synchronize()
    n_warm = len(segments)
    devices = _devices(eng)
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if trace:
        eng.renderer.render = span("renderer.render", eng.renderer.render)
        eng._settle_pending = span("engine.settle", eng._settle_pending)
        update = span("engine.update", eng.update)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in devices):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        eng.update = update
    # what set-up left behind is not walked by the window's collections
    gc.collect()
    gc.freeze()
    setup_s = process_age_s()
    starts = []
    mark = torch.profiler.record_function("rtbench.window") if trace \
        else None
    if mark is not None:
        mark.__enter__()
    t0 = time.perf_counter()
    while True:
        starts.append(time.perf_counter())
        frame()
        if time.perf_counter() - t0 >= seconds:
            break
    eng.renderer.synchronize()
    t_end = time.perf_counter()
    if mark is not None:
        mark.__exit__(None, None, None)
    trace_events = None
    if trace:
        prof.__exit__(None, None, None)
        trace_events = _chrome_events(prof)

    window = segments[n_warm:]
    window_segments = int(torch.stack([s.to(devices[0]) for s in window])
                          .sum()) if window else 0
    last_segments = int(segments[-1])
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)
    p = eng._last_params
    overwrite = frames.moving or not p.accumulate
    n_pixels = p.width * p.height
    pixels = np.arange(n_pixels) if overwrite else \
        _sample_pixels(seed, n_pixels, STILL_PIXELS)
    fb = eng.renderer.read_framebuffer().reshape(-1, 4)
    run = dict(
        seed=int(seed),
        overwrite=overwrite, dt=frames.dt, width=p.width, height=p.height,
        bounces=int(p.bounces), skybox=bool(p.skybox),
        n_frames=len(segments), frame_arg=int(p.frames), deltas=frames.sent,
        pixels=pixels, values=fb[pixels], last_segments=last_segments,
        window_frames=len(window), window_segments=window_segments,
        window_s=t_end - t0,
        periods=np.diff(np.asarray(starts + [t_end])).tolist(),
        setup_s=setup_s, memory_peak_bytes=int(peak),
        devices=[str(d) for d in devices], events=trace_events)
    eng.scene_manager.shutdown()
    del eng, fb
    gc.unfreeze()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return run


def _chrome_events(prof) -> list:
    """The profiler's timeline (kernels, copies, host spans) as Chrome trace
    events, read from a file in the run's temporary directory."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_timeline(events: list) -> dict:
    """Device activity of a traced window from its Chrome events: kernels
    (name, start us, duration us, device), the busy intervals merged per
    device, and the window's span (us) from the first host span."""
    kernels, busy = [], {}
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy",
                                              "gpu_memset"):
            continue
        dev = (e.get("args") or {}).get("device", e.get("pid"))
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        busy.setdefault(dev, []).append((start, start + dur))
        if cat == "kernel":
            kernels.append((e["name"], start, dur, dev))
    merged = {}
    for dev, iv in busy.items():
        iv.sort()
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        merged[dev] = out
    return dict(kernels=kernels, busy=merged)


def host_spans(events: list) -> list:
    """(name, start us, end us) of the benchmark's host spans (not their
    projections onto the device's timeline, ``gpu_user_annotation``)."""
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation" \
                and str(e.get("name", "")).startswith("rtbench."):
            out.append((e["name"][len("rtbench."):], float(e["ts"]),
                        float(e["ts"]) + float(e.get("dur", 0.0))))
    return out


def reading(run: dict, work: dict | None) -> dict:
    """What a metric's reader reads: the run's window (frames, exact
    segments, seconds, frame periods, set-up seconds) and, in a traced run,
    its spans, the device timeline and the cell's frozen work."""
    tl = device_timeline(run["events"] or [])
    spans = host_spans(run["events"] or [])
    window = [s for s in spans if s[0] == "window"]
    seconds: dict[str, list] = {}
    for name, a, b in spans:
        seconds.setdefault(name, []).append((b - a) / 1e6)
    return dict(frames=run["window_frames"], segments=run["window_segments"],
                width=run["width"], height=run["height"],
                window_s=run["window_s"], periods=run["periods"],
                setup_s=run["setup_s"], spans=seconds, host_spans=spans,
                kernels=tl["kernels"], busy=tl["busy"],
                window_us=window[0][1:] if window else None, work=work,
                devices=run["devices"])


def busy_seconds(tr: dict) -> float:
    """Seconds in which some device operation ran, inside the traced window,
    averaged over the cards used."""
    if not tr["busy"] or tr["window_us"] is None:
        return 0.0
    lo, hi = tr["window_us"][0], tr["window_us"][1]
    per = []
    for iv in tr["busy"].values():
        per.append(sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in iv))
    n = max(len(tr["devices"]), 1)
    return sum(per) / n / 1e6


def breakdown(tr: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps named by the host span that was running at their middle."""
    by_name: dict[str, float] = {}
    for name, _, dur, _ in tr["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    if tr["window_us"] is not None:
        lo, hi = tr["window_us"]
        for iv in tr["busy"].values():
            edges = [(lo, lo)] + [tuple(x) for x in iv] + [(hi, hi)]
            for (_, a), (b, _) in zip(edges, edges[1:]):
                if b > a:
                    gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted(tr["host_spans"], key=lambda s: s[2] - s[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        inner = next((s[0] for s in spans if s[1] <= mid <= s[2]), "outside")
        named.append([inner, (b - a) / 1e6])
    return dict(device_ops=[[k[:200], v] for k, v in ops], idle_gaps=named)


def kind_of(devices: list) -> str:
    import torch
    cuda = [d for d in devices if d.startswith("cuda")]
    if cuda:
        return torch.cuda.get_device_name(torch.device(cuda[0]))
    return "cpu"


def result(man: dict, cell: dict, run: dict, checks: dict, correct: bool,
           trace: bool, root: Path = manifest.ROOT) -> dict:
    """The run's last line: ``correct``, ``attempted`` and ``failed``
    frames, the metrics, the device, with ``--trace 1`` the breakdown, and
    the compared numbers with their limits last."""
    dev = dict(platform="gpu", kind=kind_of(run["devices"]),
               count=len(run["devices"]),
               memory_peak_bytes=run["memory_peak_bytes"])
    out = dict(correct=bool(correct), attempted=run["window_frames"],
               failed=0)
    rd = reading(run, manifest.cell_data(cell["name"], root).get("work"))
    if trace:
        wanted = manifest.per_layer(man, cell["name"])
        dev.update(busy_s=busy_seconds(rd), window_s=run["window_s"])
        out["breakdown"] = breakdown(rd)
    else:
        wanted = manifest.end_to_end(man, cell["name"])
    metrics = {}
    for m in wanted:
        v = manifest.reader(m["name"], root).read(rd)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    out.update(metrics=metrics, device=dev, checks=checks)
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", size: tuple | None = None,
             root: Path = manifest.ROOT, hook=None):
    """One run of cell ``name``: (the result line, the run's record)."""
    import torch
    from rtbench.reference import compare

    man = manifest.load(root)
    cell = manifest.cell(man, name)
    run, inputs = drive(cell, seed, seconds, trace, device, size, root,
                        hook=hook)
    t0 = time.perf_counter()
    ref = compare.reference_outputs(inputs, run, device, torch.float32)
    run["reference_s"] = time.perf_counter() - t0
    found = compare.numbers(run["values"], ref["values"],
                            run["last_segments"], ref["segments"])
    limits = manifest.cell_data(name, root).get("limits", {})
    correct, checks = compare.judge(found, limits)
    return result(man, cell, run, checks, correct, trace, root), run
