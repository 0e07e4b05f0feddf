"""The readers of the program's own spans and counters
(``ray_tracer_2_tpu_torch.spans``) on a made-up record of two frames, and
on a record with nothing in it, or no such module, where each reads None."""
import bisect
import statistics
import sys

import pytest

from rtbench import manifest

NEW = ("engine.settle_wait_ms", "engine.camera_ms", "engine.relaunch_ms",
       "device.interframe_gap_ms", "megakernel.lane_occupancy",
       "megakernel.rows_per_segment")
#: every reader of the program's record: the six and the host's own work
#: a frame
READERS = NEW + ("engine.host_work_ms",)
US = 1000   # ns


def made_up() -> dict:
    """Two frames in ``Engine.update``'s order: the frame's dispatch and
    record, then the wait for the frame before (name, parent row, frame,
    start ns, end ns)."""
    rows = [
        ("engine.update", -1, 0, 0, 1000 * US),
        ("engine.camera", 0, 0, 10 * US, 110 * US),
        ("engine.dispatch", 0, 0, 120 * US, 400 * US),
        ("megakernel.launch", 2, 0, 200 * US, 330 * US),
        ("engine.event", 0, 0, 410 * US, 450 * US),
        ("engine.settle", 0, 0, 460 * US, 960 * US),
        ("engine.settle.wait", 5, 0, 470 * US, 870 * US),
        ("engine.update", -1, 1, 1000 * US, 1800 * US),
        ("engine.camera", 7, 1, 1010 * US, 1060 * US),
        ("engine.dispatch", 7, 1, 1070 * US, 1250 * US),
        ("megakernel.launch", 9, 1, 1100 * US, 1150 * US),
        ("engine.event", 7, 1, 1260 * US, 1290 * US),
        ("engine.settle", 7, 1, 1300 * US, 1520 * US),
        ("engine.settle.wait", 12, 1, 1310 * US, 1510 * US),
    ]
    return dict(session=1, spans=rows, frames=2, totals=totals(rows),
                counters={"device.interframe_gap_ms": 0.9,
                          "device.interframe_gaps": 3},
                launches={"megakernel": 2},
                counts={"megakernel": dict(rows=4500, turns=100,
                                           active_lanes=2400)})


def totals(rows) -> dict:
    """The record's ``totals`` of its span rows (``self_ms`` left 0)."""
    out = {}
    for name, _, _, a, b in rows:
        t = out.setdefault(name, dict(n=0, ms=0.0, self_ms=0.0))
        t["n"] += 1
        t["ms"] += (b - a) / 1e6
    return out


def empty() -> dict:
    return dict(session=0, spans=[], frames=0, totals={}, counters={},
                launches={}, counts={})


def read(name, record, monkeypatch, segments=1000):
    from ray_tracer_2_tpu_torch import spans
    monkeypatch.setattr(spans, "record", lambda: record)
    return manifest.reader(name).read(dict(segments=segments))


def test_readers_on_a_made_up_record(monkeypatch):
    r = lambda name: read(name, made_up(), monkeypatch)
    assert r("engine.settle_wait_ms") == pytest.approx((0.4 + 0.2) / 2)
    assert r("engine.camera_ms") == pytest.approx((0.1 + 0.05) / 2)
    # end of frame 0's wait to the end of frame 1's record: 420 us; frame
    # 1's wait has no frame after it
    assert r("engine.relaunch_ms") == pytest.approx(0.42)
    assert r("device.interframe_gap_ms") == pytest.approx(0.3)
    assert r("megakernel.lane_occupancy") == pytest.approx(75.0)
    assert r("megakernel.rows_per_segment") == pytest.approx(4.5)


def frames(*updates) -> dict:
    """A record of updates, each a list of (span, start us, end us)."""
    rows = []
    for k, spans in enumerate(updates):
        root = len(rows)
        rows.append(("engine.update", -1, k, k * 2000 * US,
                     (k + 1) * 2000 * US))
        rows += [(name, root, k, (k * 2000 + a) * US, (k * 2000 + b) * US)
                 for name, a, b in spans]
    return dict(made_up(), spans=rows, frames=len(updates))


def test_relaunch_pairs_each_wait_with_the_next_frames_record(monkeypatch):
    """The first update has no frame before it to wait for; the third
    waits twice (two frames in flight), and its last wait counts; the
    fourth has no update after it."""
    rec = frames(
        [("engine.event", 400, 450)],
        [("engine.event", 400, 460), ("engine.settle.wait", 500, 1500)],
        [("engine.event", 300, 340), ("engine.settle.wait", 400, 900),
         ("engine.settle.wait", 900, 1700)],
        [("engine.event", 600, 650), ("engine.settle.wait", 700, 1600)],
    )
    reader = manifest.reader("engine.relaunch_ms")
    # 3500 us -> 4340 us, 5700 us -> 6650 us
    assert reader.relaunches(rec) == pytest.approx([0.84, 0.95])
    assert read("engine.relaunch_ms", rec, monkeypatch) == \
        pytest.approx((0.84 + 0.95) / 2)


def test_host_work_is_the_update_less_its_waits(monkeypatch):
    """The made-up record's two updates, 1000 and 800 us, each less its
    wait, 400 and 200 us; then an update with no frame before it to wait
    for, and one with two frames in flight, whose both waits count."""
    assert read("engine.host_work_ms", made_up(), monkeypatch) == \
        pytest.approx(0.6)
    rec = frames(
        [("engine.event", 400, 450)],
        [("engine.settle.wait", 500, 1500)],
        [("engine.settle.wait", 400, 900), ("engine.settle.wait", 900, 1700)],
    )
    rec["totals"] = totals(rec["spans"])
    assert read("engine.host_work_ms", rec, monkeypatch) == \
        pytest.approx((2.0 + 1.0 + 0.7) / 3)


def test_host_work_is_in_the_manifest_for_every_cell():
    """It reads the frame loop, which every path runs: no list of cells,
    and every cell that reports ``frame_ms_p95`` reports it."""
    man = manifest.load()
    m = {x["name"]: x for x in man["per_layer"]}["engine.host_work_ms"]
    assert m["source"] == "program_span" and "workloads" not in m
    assert m["moves"] == "frame_ms_p95" and m["unit"] == "ms"
    assert m["layer"] == {x["name"]: x for x in man["per_layer"]}[
        "engine.camera_ms"]["layer"]
    for w in man["workloads"]:
        assert m in manifest.per_layer(man, w["name"])


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_on_an_empty_record(name, monkeypatch):
    assert read(name, empty(), monkeypatch) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_without_the_programs_spans(name, monkeypatch):
    """A tree whose program has no spans of its own (the import fails)."""
    import ray_tracer_2_tpu_torch
    monkeypatch.delattr(ray_tracer_2_tpu_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "ray_tracer_2_tpu_torch.spans", None)
    with pytest.raises(ImportError):
        from ray_tracer_2_tpu_torch import spans  # noqa: F401
    assert manifest.reader(name).read(dict(segments=1000)) is None


def test_the_six_are_in_the_manifest():
    """The megakernel's two counters list the cells whose frames take the
    megakernel, as its other two metrics do: both sponza cells, and any
    that a later cell-adding PR names (its frames take the megakernel, and
    it adds its own name). The other four read the frame loop that every
    path runs, and keep no list."""
    man = manifest.load()
    got = {m["name"]: m for m in man["per_layer"]}
    cells = {w["name"] for w in man["workloads"]}
    for name in NEW:
        assert got[name]["source"] in ("program_span", "program_counter")
        if name.startswith("megakernel."):
            listed = got[name]["workloads"]
            assert {"sponza268k.still", "sponza268k.orbit1440"} <= set(listed)
            assert set(listed) <= cells
            assert listed == got["megakernel_roofline"]["workloads"] == \
                got["megakernel.ns_per_segment"]["workloads"]
        else:
            assert "workloads" not in got[name]


#: the device's operations in a Chrome trace, and the host's launches
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: a wait this long (us) blocked the host until its frame ended on the card
BLOCKED_US = 50.0
#: blocked waits whose median puts a frame's device times on the host clock
NEAR = 21
#: points by which the share of relaunches that outlast their frame may
#: stand off ``100 - engine.queued_pct``: seven traced orbit runs on an H100
#: read -0.031 to +0.037 (4.5-15.4% of frames not queued)
SHARE_GAP = 0.5


def relaunch_against_card(events: list) -> list:
    """Per update k of a traced window, from its Chrome events: (the
    relaunch, update k's last ``engine.settle.wait`` end to update k + 1's
    ``engine.event`` end; what was left of frame k on the card when that
    wait ended), in us. A device operation belongs to the update whose span
    holds its launch (``correlation``); frame k ends with its last one.

    The trace's device clock drifts against its host clock, by tens of us
    over a window and on some runs by milliseconds, so a frame's end is put
    on the host clock by the waits around it: a wait of ``BLOCKED_US`` or
    more returned as the frame it waited for ended, and the median of that
    frame's end less the wait's end over the ``NEAR`` nearest such waits is
    taken off. The wake after the wait (10-20 us) is thereby left in
    what remains of the frame."""
    updates, spans, launches, ops = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append((corr, a, b))
        elif cat in LAUNCH_CATS:
            launches[corr] = a
        elif cat != "gpu_user_annotation":
            if name == "engine.update":
                updates.append((a, b))
            elif name in ("engine.settle.wait", "engine.event"):
                spans.append((name, a, b))
    updates.sort()
    starts = [a for a, _ in updates]

    def update_of(t):
        k = bisect.bisect_right(starts, t) - 1
        return k if k >= 0 and t <= updates[k][1] else None

    waits, recorded, last = {}, {}, {}
    for name, a, b in spans:
        k = update_of(a)
        if k is None:
            continue
        if name == "engine.event":
            recorded[k] = b
        elif b >= waits.get(k, (a, b))[1]:
            waits[k] = (a, b)
    for corr, a, b in ops:
        k = update_of(launches.get(corr, -1.0))
        if k is not None:
            last[k] = max(b, last.get(k, b))
    blocked = sorted(k for k, (a, b) in waits.items()
                     if b - a >= BLOCKED_US and k - 1 in last)
    offsets = [last[k - 1] - waits[k][1] for k in blocked]
    out = []
    for k, (_, w) in sorted(waits.items()):
        if k + 1 not in recorded or k not in last or not blocked:
            continue
        hi = min(len(blocked), max(bisect.bisect(blocked, k) + NEAR // 2,
                                   NEAR))
        off = statistics.median(offsets[max(0, hi - NEAR):hi])
        out.append((recorded[k + 1] - w, last[k] - off - w))
    return out


def test_relaunch_against_card_on_made_up_events():
    """Three updates on a device clock 5 ms ahead of the host's: the
    device operations of each found by their launch's correlation, and put
    on the host clock by update 1's blocked wait for frame 0."""
    x = lambda cat, name, ts, dur, **args: dict(
        ph="X", cat=cat, name=name, ts=ts, dur=dur, args=args)
    events = [
        x("cpu_op", "engine.update", 0, 1000),
        x("cuda_runtime", "cudaLaunchKernel", 100, 10, correlation=1),
        x("cpu_op", "engine.event", 290, 60),
        x("cuda_runtime", "cudaMemcpyAsync", 300, 5, correlation=2),
        x("cpu_op", "engine.settle.wait", 400, 500),
        x("gpu_user_annotation", "engine.update", 5000, 5000),
        x("kernel", "render_single", 5800, 1100, correlation=1),
        x("gpu_memcpy", "Memcpy DtoH", 6900, 40, correlation=2),
        x("cpu_op", "engine.update", 1000, 1000),
        x("cuda_driver", "cuLaunchKernel", 1100, 10, correlation=3),
        x("cpu_op", "engine.event", 1500, 100),
        x("cpu_op", "engine.settle.wait", 1650, 300),
        x("kernel", "render_single", 6940, 760, correlation=3),
        x("cpu_op", "engine.update", 2000, 1000),
        x("cpu_op", "engine.event", 2300, 100),
    ]
    # frame 0 ends at 6940 on the device, 10 us before update 1's wait
    # (1950 us on the host): 4990 us off; frame 1 ends at 7700
    assert relaunch_against_card(events) == \
        [(700.0, 6940.0 - 4990.0 - 900.0), (450.0, 7700.0 - 4990.0 - 1950.0)]


@pytest.mark.cuda
def test_relaunches_longer_than_the_cards_frame_are_the_frames_not_queued(
        card):
    """On a traced orbit run the card idles before frame k + 1 where the
    host's relaunch after update k's wait outlasts what was left of frame k
    on the card when that wait ended (each frame's own, from the trace). So
    the share of such relaunches is ``100 - engine.queued_pct``, the share
    of frames whose frame before had finished when their events were
    recorded, but for frame k ending inside update k + 1's record, between
    the counter's ``query`` and the span's end, or inside the wake. And
    the relaunches the trace gives are the reader's."""
    from rtbench import harness
    from rtbench.program_spans import last_session

    out, run = harness.run_cell("sponza268k.orbit1440", 2 ** 31 + 41, 5.0,
                                True)
    frames = relaunch_against_card(run["events"])
    share = 100.0 * sum(r > left for r, left in frames) / len(frames)
    not_queued = 100.0 - out["metrics"]["engine.queued_pct"]["value"]
    mean_ms = sum(r for r, _ in frames) / len(frames) / 1000.0
    gaps = manifest.reader("engine.relaunch_ms").relaunches(last_session())
    assert len(frames) >= 0.99 * len(gaps)
    assert mean_ms == pytest.approx(sum(gaps) / len(gaps), rel=0.02)
    assert abs(share - not_queued) <= SHARE_GAP, (share, not_queued)
