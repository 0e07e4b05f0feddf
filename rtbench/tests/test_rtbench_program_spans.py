"""The readers of the program's own spans and counters
(``ray_tracer_2_tpu_torch.spans``) on a made-up record of two frames, and
on a record with nothing in it, or no such module, where each reads None."""
import sys

import pytest

from rtbench import manifest

NEW = ("engine.settle_wait_ms", "engine.camera_ms", "engine.relaunch_ms",
       "device.interframe_gap_ms", "megakernel.lane_occupancy",
       "megakernel.rows_per_segment")
US = 1000   # ns


def made_up() -> dict:
    """Two frames: (name, parent row, frame, start ns, end ns)."""
    rows = [
        ("engine.update", -1, 0, 0, 1000 * US),
        ("engine.camera", 0, 0, 10 * US, 110 * US),
        ("engine.settle", 0, 0, 120 * US, 620 * US),
        ("engine.settle.wait", 2, 0, 130 * US, 530 * US),
        ("engine.dispatch", 0, 0, 630 * US, 900 * US),
        ("megakernel.launch", 4, 0, 700 * US, 830 * US),
        ("engine.update", -1, 1, 1000 * US, 1800 * US),
        ("engine.camera", 6, 1, 1010 * US, 1060 * US),
        ("engine.settle", 6, 1, 1090 * US, 1320 * US),
        ("engine.settle.wait", 8, 1, 1100 * US, 1300 * US),
        ("engine.dispatch", 6, 1, 1330 * US, 1500 * US),
        ("megakernel.launch", 10, 1, 1400 * US, 1450 * US),
    ]
    totals = {}
    for name, _, _, a, b in rows:
        t = totals.setdefault(name, dict(n=0, ms=0.0, self_ms=0.0))
        t["n"] += 1
        t["ms"] += (b - a) / 1e6
    return dict(session=1, spans=rows, frames=2, totals=totals,
                counters={"device.interframe_gap_ms": 0.9,
                          "device.interframe_gaps": 3},
                launches={"megakernel": 2},
                counts={"megakernel": dict(rows=4500, turns=100,
                                           active_lanes=2400)})


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
    # end of the wait to the end of the launch: 300 us and 150 us
    assert r("engine.relaunch_ms") == pytest.approx(0.225)
    assert r("device.interframe_gap_ms") == pytest.approx(0.3)
    assert r("megakernel.lane_occupancy") == pytest.approx(75.0)
    assert r("megakernel.rows_per_segment") == pytest.approx(4.5)


@pytest.mark.parametrize("name", NEW)
def test_readers_read_none_on_an_empty_record(name, monkeypatch):
    assert read(name, empty(), monkeypatch) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_read_none_without_the_programs_spans(name, monkeypatch):
    """A tree whose program has no spans of its own (the import fails)."""
    import ray_tracer_2_tpu_torch
    monkeypatch.delattr(ray_tracer_2_tpu_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "ray_tracer_2_tpu_torch.spans", None)
    with pytest.raises(ImportError):
        from ray_tracer_2_tpu_torch import spans  # noqa: F401
    assert manifest.reader(name).read(dict(segments=1000)) is None


def test_the_six_are_in_the_manifest():
    got = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in NEW:
        assert "workloads" not in got[name]
        assert got[name]["source"] in ("program_span", "program_counter")
