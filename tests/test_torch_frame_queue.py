"""``Engine.update``'s frame queue: each ``update`` dispatches its frame and
records its events before it waits, and then waits only for the frame
before, so the card holds two frames and goes from one to the next with no
host gap. Each frame in flight carries its own record (segment count,
parameters, scene, dispatch time), ``FrameStats`` reports the settled
frame, a frame's time is its own (settle less the later of its dispatch
and the settle before), and the adaptive-motion ladder reads the newest
settled moving frame.

The CPU tests drive a real ``Engine`` on a small scene with a stub renderer
that claims a card and stub CUDA events whose completion the test decides.
The last test runs on a card and skips without one. The file imports
neither JAX nor the JAX package; on the card:

    python3 -m pytest --noconftest -q tests/test_torch_frame_queue.py
"""
import dataclasses
import threading
import types

import pytest
import torch

from ray_tracer_2_tpu_torch import spans
from ray_tracer_2_tpu_torch.engine import Engine
from ray_tracer_2_tpu_torch.engine import engine as engine_mod
from ray_tracer_2_tpu_torch.scene.scenes import SceneName

W, H = 192, 108
CPU = [torch.profiler.ProfilerActivity.CPU]


class Clock:
    """The engine's ``time.perf_counter``: moves only when told to."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class StubEvent:
    """A CUDA event whose completion the test decides: ``done`` until then
    False; ``synchronize`` notes the wait, advances the clock by ``wait_s``
    and completes it."""

    made: list = []
    log: list = []
    clock: Clock = None
    wait_s = 0.0

    def __init__(self, enable_timing=False):
        self.frame = len(StubEvent.made) + 1
        self.done = False
        StubEvent.made.append(self)

    def record(self, stream=None):
        StubEvent.log.append(("record", self.frame))

    def query(self):
        return self.done

    def synchronize(self):
        StubEvent.log.append(("wait", self.frame))
        if not self.done:
            StubEvent.clock.now += StubEvent.wait_s
        self.done = True


class StubRenderer:
    """What ``Engine`` uses of a ``Renderer`` on one card: each frame gets
    a segment count of its own (1000 times its number) and notes its
    parameters; a dispatch takes ``dispatch_s`` of the clock."""

    def __init__(self, clock):
        self.mesh = types.SimpleNamespace(distinct=[torch.device("cuda", 0)])
        self.clock = clock
        self.dispatch_s = 0.001
        self.params = []
        self.last_segments = None
        self.framebuffer = torch.zeros(1)

    def render(self, scene, params):
        self.params.append(params)
        n = len(self.params)
        StubEvent.log.append(("render", n))
        self.last_segments = torch.tensor(1000 * n, dtype=torch.int64)
        self.clock.now += self.dispatch_s
        return self.framebuffer


@pytest.fixture
def queued(monkeypatch):
    """A CPU engine whose frames look like a card's: stub renderer, stub
    events, a clock of the test's own."""
    eng = Engine(W, H, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cpu", mesh=None)
    clock = Clock()
    StubEvent.made, StubEvent.log = [], []
    StubEvent.clock, StubEvent.wait_s = clock, 0.0
    monkeypatch.setattr(torch.cuda, "Event", StubEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(engine_mod, "time", clock)
    eng.renderer = StubRenderer(clock)
    yield eng, clock
    eng.scene_manager.shutdown()


def _update_log(eng):
    """The stub log of one ``update``."""
    start = len(StubEvent.log)
    eng.update(dt=0.016)
    return StubEvent.log[start:]


def test_update_queues_its_frame_then_waits_for_the_one_before(queued):
    eng, _ = queued
    assert _update_log(eng) == [("render", 1), ("record", 1)]
    assert not StubEvent.made[0].done         # frame 1 stays on the card
    for n in range(2, 6):
        assert _update_log(eng) == [("render", n), ("record", n),
                                       ("wait", n - 1)]
        assert not StubEvent.made[n - 1].done  # never frame n itself
        assert [f.number for f in eng._pending] == [n]
    # sync: the frame before, then this one
    eng.update(dt=0.016, sync=True)
    assert StubEvent.log[-3:] == [("record", 6), ("wait", 5), ("wait", 6)]
    assert not eng._pending and eng.stats.frame == 6
    assert eng.stats.timing_exact


def test_stats_report_the_settled_frames_own_numbers(queued):
    eng, clock = queued
    StubEvent.wait_s = 0.004
    eng.update(dt=0.016)
    assert eng.stats.frame == 0               # nothing settled yet
    host = eng.scene_manager.scene
    for n in range(2, 5):
        moving = n == 3
        eng.update(dt=0.016, is_moving=moving)
        s = eng.stats
        settled = eng._settled
        assert s.frame == settled.number == n - 1
        assert settled.params is eng.renderer.params[n - 2]
        assert eng._last_params is eng.renderer.params[n - 1]
        assert settled.host is host
        # frame n - 1's own segment count over its own time
        assert settled.rays == 1000 * (n - 1)
        assert s.mrays_per_s * s.frame_time_ms * 1e3 == pytest.approx(
            1000 * (n - 1))
        assert s.accumulated_frames == max(settled.params.frames, 0)
        assert not s.timing_exact
    # frame 3 moved: half size, one bounce; frame 2 and 4 are full size
    widths = [p.width for p in eng.renderer.params]
    assert widths == [W, W, W // 2, W]


def test_a_frames_time_is_its_own(queued):
    """``_last_render_s`` = settle - max(dispatch, the settle before)."""
    eng, clock = queued
    StubEvent.wait_s = 0.010
    eng.update(dt=0.016)                      # t0 = 0, dispatched at 0.001
    eng.update(dt=0.016)                      # t0 = 0.001; frame 1 settles
    assert clock.now == pytest.approx(0.012)
    assert eng._settled.number == 1
    assert eng._last_render_s == pytest.approx(0.012 - 0.0)
    eng.update(dt=0.016)                      # t0 = 0.012; frame 2 settles
    # frame 2 was dispatched at 0.001 but the card reached it at frame 1's
    # settle, 0.012: 0.023 - 0.012
    assert eng._last_render_s == pytest.approx(0.011)
    assert eng.stats.frame_time_ms == pytest.approx(11.0)
    # frame 3 settles by a stats read at 0.026; the host then idles, so
    # frame 4, dispatched at 0.526, counts from its dispatch
    StubEvent.made[2].done = True
    clock.now += 0.003
    assert eng.stats.frame == 3
    assert eng._last_render_s == pytest.approx(0.026 - 0.023)
    clock.now += 0.5
    eng.update(dt=0.016)                      # t0 = 0.526
    eng.update(dt=0.016)                      # frame 4 settles at 0.538
    assert eng._settled.number == 4
    assert eng._last_render_s == pytest.approx(0.538 - 0.526)


def test_the_ladder_reads_the_newest_settled_moving_frame(queued,
                                                          monkeypatch):
    eng, clock = queued
    eng.params = dataclasses.replace(eng.params, adaptive_motion=True,
                                     motion_target_ms=33.0)
    StubEvent.wait_s = 0.200                  # 200 ms a moving frame
    asked = []
    real = engine_mod.pick_motion_scale

    def pick(scale, render_s, target):
        asked.append((scale, render_s))
        return real(scale, render_s, target)
    monkeypatch.setattr(engine_mod, "pick_motion_scale", pick)
    for _ in range(4):
        eng.update(dt=0.016, is_moving=True)
    widths = [p.width for p in eng.renderer.params]
    # frames 1 and 2 dispatch before any frame has settled; frame 3 reads
    # frame 1 (200 ms at scale 2: scale 6 fits 33 ms); frame 4 reads frame
    # 2, also at scale 2 and slow
    assert widths == [W // 2, W // 2, W // 6, W // 6]
    assert [a[0] for a in asked] == [2, 2]
    # frame 1: dispatched at 0, settled at 0.202
    assert asked[0][1] == pytest.approx(0.202)
    # frame 2: settled at 0.403, less frame 1's settle at 0.202
    assert asked[1][1] == pytest.approx(0.201)
    # a still frame settles: no moving frame to read, the scale is kept
    StubEvent.wait_s = 0.0001
    eng.update(dt=0.016)
    eng.update(dt=0.016)
    eng.update(dt=0.016, is_moving=True)      # frame 5 is still: kept
    assert len(asked) == 2 and eng.renderer.params[-1].width == W // 6


def test_a_stats_read_on_another_thread_settles_the_newest(queued):
    """A non-blocking ``stats`` read (the viewer's ``/state``) that finds
    the newest frame finished settles it; the next ``update`` then waits on
    nothing older and the frame after settles in its turn."""
    eng, clock = queued
    StubEvent.wait_s = 0.005
    for _ in range(2):
        eng.update(dt=0.016)
    assert [f.number for f in eng._pending] == [2]
    got = []
    reader = threading.Thread(target=lambda: got.append(eng.stats))
    reader.start()
    reader.join()
    assert got[0].frame == 1                  # frame 2 still running
    StubEvent.made[1].done = True             # the card finishes frame 2
    clock.now += 0.002
    reader = threading.Thread(target=lambda: got.append(eng.stats))
    reader.start()
    reader.join()
    assert got[1].frame == 2 and not eng._pending
    settled_at = clock.now
    # settled once, its synchronize returning at once
    assert StubEvent.log.count(("wait", 2)) == 1
    log = _update_log(eng)
    assert log == [("render", 3), ("record", 3)]
    assert [f.number for f in eng._pending] == [3]
    assert eng.stats.frame == 2
    log = _update_log(eng)
    assert log == [("render", 4), ("record", 4), ("wait", 3)]
    assert eng._settled.number == 3
    # frame 3's time runs from its dispatch, after frame 2's settle
    assert eng._settled.render_s == pytest.approx(
        clock.now - max(eng._settled.t0, settled_at))
    assert eng.stats.frame == 3 and eng._settled.rays == 3000


def test_dispatch_counters_under_a_profiler(queued):
    """``engine.dispatches`` counts every frame of a session,
    ``engine.dispatches_queued`` those whose frame before had not finished
    when their events were recorded; nothing is counted with no
    session."""
    eng, _ = queued
    eng.update(dt=0.016)
    with torch.profiler.profile(activities=CPU):
        eng.update(dt=0.016)                  # frame 1 unfinished: queued
        eng.update(dt=0.016)                  # frame 2 unfinished: queued
        StubEvent.made[2].done = True         # the card idles after 3
        eng.update(dt=0.016)                  # not queued
        eng.update(dt=0.016)                  # frame 4 unfinished: queued
    rec = spans.record()
    assert rec["counters"]["engine.dispatches"] == 4
    assert rec["counters"]["engine.dispatches_queued"] == 3
    eng.update(dt=0.016)
    assert spans.record()["counters"]["engine.dispatches"] == 4


@pytest.mark.parametrize("counters,want", [
    ({"engine.dispatches": 8, "engine.dispatches_queued": 6}, 75.0),
    ({"engine.dispatches": 5}, 0.0),
    ({"engine.dispatches_queued": 3}, None),
    ({}, None),
])
def test_queued_pct_reader(counters, want, monkeypatch):
    """``rtbench/metrics/engine.queued_pct.py`` on a synthetic record: 100
    times queued over dispatched; None where nothing was dispatched."""
    from rtbench import manifest
    rec = dict(session=1, spans=[], frames=2, counters=counters,
               totals={"engine.update": dict(n=2, ms=1.0, self_ms=0.1)},
               launches={}, counts={})
    monkeypatch.setattr(spans, "record", lambda: rec)
    got = manifest.reader("engine.queued_pct").read(dict(segments=0))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.cuda
def test_frames_queue_on_the_card():
    """On the card, at a size whose frame takes over 3 ms (sponza, 1080p,
    5 bounces): at least 80% of a session's frames are queued behind the
    frame before, the card's mean gap between frames is under 0.1 ms, and
    each settled frame's segment count, read from its pinned host slot,
    is the kernel's own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    eng = Engine(1920, 1080, initial_scene=SceneName.SPONZA,
                 block_on_initial_scene=True, device="cuda", mesh=None)
    for _ in range(3):
        eng.update(dt=0.016)
    eng.renderer.synchronize()
    segs, rays = {}, {}
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for _ in range(20):
            eng.update(dt=0.016)
            segs[eng._frame_counter] = eng.renderer.last_segments
            settled = eng._settled
            rays[settled.number] = settled.rays
    eng.renderer.synchronize()
    rec = spans.record()
    c = rec["counters"]
    assert c["engine.dispatches"] == 20
    assert c["engine.dispatches_queued"] >= 16, c
    assert c["device.interframe_gaps"] >= 17
    gap = c["device.interframe_gap_ms"] / c["device.interframe_gaps"]
    assert 0.0 < gap < 0.1, gap
    checked = [n for n in rays if n in segs]
    assert len(checked) >= 18
    for n in checked:
        assert rays[n] == int(segs[n]), n
    ms = eng.stats.frame_time_ms
    assert ms > 3.0, ms
    eng.scene_manager.shutdown()
