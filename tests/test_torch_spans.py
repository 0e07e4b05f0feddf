"""The port's spans and counters (``ray_tracer_2_tpu_torch/spans.py``):
nothing is recorded without a profiler session; under one, each
``Engine.update`` gives one tree of spans whose self times add up to its
root, each span has its twin range on the profiler's clock,
a new session starts a new record, and the kernels' count deltas cover the
session alone. The last test runs on a card (the megakernel's counts and
the card's wait between frames) and skips without one.

The file imports neither JAX nor the JAX package; on the card:

    python3 -m pytest --noconftest -q tests/test_torch_spans.py
"""
import dataclasses
import json
import sys
import threading
from pathlib import Path

import pytest
import torch

from ray_tracer_2_tpu_torch import spans
from ray_tracer_2_tpu_torch.engine import Engine
from ray_tracer_2_tpu_torch.scene.scenes import SceneName

CPU = [torch.profiler.ProfilerActivity.CPU]

#: the children of each span of one ``Engine.update`` on the CPU, in order
TREE = {
    "engine.update": ["engine.poll", "engine.camera", "engine.dispatch",
                      "engine.event", "engine.settle"],
    "engine.settle": ["engine.settle.wait", "engine.stats"],
    "engine.dispatch": ["renderer.render"],
    "renderer.render": ["renderer.prepare", "megakernel.call",
                        "renderer.blend"],
}


@pytest.fixture(scope="module")
def engine():
    # antialias sends the small scene through the megakernel's plain version
    eng = Engine(24, 16, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cpu", mesh=None)
    eng.params = dataclasses.replace(eng.params, antialias=True)
    eng.update(dt=0.016)
    yield eng
    eng.scene_manager.shutdown()


def test_profiler_flag_is_pinned():
    """The flag the span sites read is torch's own, and follows a session:
    a torch that moves it fails here."""
    assert spans.FLAG == "_is_profiler_enabled"
    flag = lambda: getattr(torch.autograd.profiler, spans.FLAG)
    assert flag() is False and spans.on() is False
    with torch.profiler.profile(activities=CPU):
        assert flag() is True and spans.on() is True
    assert flag() is False and spans.on() is False


def test_no_profiler_records_nothing(engine, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")
    monkeypatch.setattr(spans, "_twin", refuse)
    before = spans.record()
    for _ in range(2):
        engine.update(dt=0.016, is_moving=True)
    assert spans.span("engine.update") is spans.NULL
    after = spans.record()
    assert after["session"] == before["session"]
    assert after["spans"] == before["spans"]


def _traced(engine, n):
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(n):
            engine.update(dt=0.016, is_moving=True)
    return prof, spans.record()


def test_tree_frames_and_self_times(engine):
    _, rec = _traced(engine, 3)
    rows = rec["spans"]
    roots = [i for i, r in enumerate(rows) if r[1] == -1]
    assert [rows[i][0] for i in roots] == ["engine.update"] * 3
    assert [rows[i][2] for i in roots] == [0, 1, 2] and rec["frames"] == 3
    children = {i: [] for i in range(len(rows))}
    for i, (_, parent, _, _, _) in enumerate(rows):
        if parent >= 0:
            children[parent].append(i)
    for i, (name, parent, frame, a, b) in enumerate(rows):
        assert b is not None and a <= b
        assert [rows[c][0] for c in children[i]] == TREE.get(name, []), name
        if parent >= 0:
            p = rows[parent]
            assert p[3] <= a and b <= p[4] and frame == p[2]

    def self_ns(i):
        return rows[i][4] - rows[i][3] - sum(rows[c][4] - rows[c][3]
                                              for c in children[i])

    def subtree(i):
        return [i] + [j for c in children[i] for j in subtree(c)]
    for r in roots:
        assert sum(self_ns(j) for j in subtree(r)) == rows[r][4] - rows[r][3]
    for name, t in rec["totals"].items():
        assert t["n"] == 3, name
        assert t["self_ms"] == pytest.approx(
            sum(self_ns(i) for i, row in enumerate(rows) if row[0] == name)
            / 1e6)
    assert rec["totals"]["engine.update"]["ms"] == pytest.approx(
        sum(rows[r][4] - rows[r][3] for r in roots) / 1e6)


def test_spans_sit_on_the_profilers_clock(engine, tmp_path):
    """Each span lies inside its twin range of the exported trace (same
    name; the span reads its clock once the twin has opened and before it
    closes), most starts within 50 us of the twin's; a loaded host may
    delay a single read by more."""
    prof, rec = _traced(engine, 2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    twins = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation":
            a = float(e["ts"]) * 1e3 + base
            twins.setdefault(e["name"], []).append((a, a + e["dur"] * 1e3))
    offsets = []
    for name, _, _, start, end in rec["spans"]:
        a, b = min(twins[name], key=lambda t: abs(t[0] - start))
        assert a - 2e3 <= start and end <= b + 2e3, (name, start - a, b - end)
        offsets.append(start - a)
    offsets.sort()
    assert offsets[len(offsets) // 2] < 50e3 and offsets[-1] < 2e6, offsets


def test_a_new_session_starts_a_new_record(engine):
    _, first = _traced(engine, 2)
    _, second = _traced(engine, 1)
    assert second["session"] == first["session"] + 1
    assert first["frames"] == 2 and second["frames"] == 1
    assert second["totals"]["engine.update"]["n"] == 1


class _StubKernel:
    """What ``spans`` reads of a kernel wrapper: ``launches``, the device
    count words by device, their names and the source."""

    counts = ("rows", "turns")
    source = Path("stub_kernel.cu")

    def __init__(self):
        self.launches = 3
        self._counts = {torch.device("cpu"): torch.tensor([5, 7])}


def test_counter_deltas_cover_the_session_alone():
    k = _StubKernel()
    spans.watch(k)
    cpu = torch.device("cpu")
    k._counts[cpu] += torch.tensor([100, 100])    # before: not counted
    with torch.profiler.profile(activities=CPU):
        spans.count("frames_seen")                # opens the session
        k._counts[cpu] += torch.tensor([10, 3])
        k.launches += 4
        spans.count("frames_seen", 2)
    assert spans.span("anything") is spans.NULL   # ends the session
    k._counts[cpu] += torch.tensor([1000, 1000])  # after: not counted
    k.launches += 50
    rec = spans.record()
    assert rec["counters"] == {"frames_seen": 3}
    assert rec["counts"]["stub_kernel"] == {"rows": 10, "turns": 3}
    assert rec["launches"]["stub_kernel"] == 4
    assert spans.record() is rec                  # read once, then kept


def test_threads_record_whole_rows():
    """Spans opened from many threads at once, switching as often as the
    interpreter allows: one session is opened, every row is whole (a
    child's parent is its own thread's span, inside it, of its frame) and
    each root has its own frame number."""
    n_threads, n = 16, 200
    together = threading.Barrier(n_threads)

    def work(k):
        together.wait(timeout=60)   # the first spans open the session
        for _ in range(n):
            with spans.span(f"stress.outer.{k}"):
                with spans.span(f"stress.inner.{k}"):
                    pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = spans.record()
    rows = rec["spans"]
    assert len(rows) == 2 * n_threads * n
    roots = [r for r in rows if r[1] == -1]
    assert sorted(r[2] for r in roots) == list(range(n_threads * n))
    for name, parent, frame, a, b in rows:
        if name.startswith("stress.inner."):
            p = rows[parent]
            assert p[0] == "stress.outer." + name.rsplit(".", 1)[1]
            assert p[2] == frame and p[3] <= a <= b <= p[4]
        else:
            assert parent == -1


@pytest.mark.cuda
def test_megakernel_counts_and_interframe_gap_on_the_card():
    """On the card: the session's megakernel count deltas equal the
    kernel's own counts read around the session, its launches equal the
    frames, and every settled frame after the first adds a gap on the
    card's clock between frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from ray_tracer_2_tpu_torch.kernels.megakernel import CUDA_MEGAKERNEL
    eng = Engine(96, 54, initial_scene=SceneName.SPONZA,
                 block_on_initial_scene=True, device="cuda", mesh=None)
    for _ in range(2):
        eng.update(dt=0.016)
    eng.renderer.synchronize()
    before, launches = CUDA_MEGAKERNEL.read_counts(), CUDA_MEGAKERNEL.launches
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for _ in range(5):
            eng.update(dt=0.016)
        eng.renderer.synchronize()
    after = CUDA_MEGAKERNEL.read_counts()
    rec = spans.record()
    got = rec["counts"]["megakernel"]
    assert got == {k: after[k] - before[k] for k in after}
    assert rec["launches"]["megakernel"] == 5 \
        == CUDA_MEGAKERNEL.launches - launches
    assert got["rows"] > 0 and 0 < got["active_lanes"] <= 32 * got["turns"]
    # frames 2 to 4 settle inside the session after a timed frame
    assert rec["counters"]["device.interframe_gaps"] == 3
    gap = rec["counters"]["device.interframe_gap_ms"] / 3
    assert 0.0 < gap < 50.0
    assert rec["totals"]["megakernel.launch"]["n"] == 5
    eng.scene_manager.shutdown()
