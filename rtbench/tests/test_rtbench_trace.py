"""The window's reduction: device timeline, busy and idle time, spans,
the breakdown, and the readers on a made-up timeline."""
import pytest

from rtbench import harness, manifest


def timeline():
    ev = lambda name, cat, ts, dur, **a: dict(ph="X", name=name, cat=cat,
                                               ts=ts, dur=dur, args=a)
    return [
        ev("rtbench.window", "user_annotation", 0.0, 1000.0),
        ev("rtbench.engine.update", "user_annotation", 0.0, 400.0),
        ev("rtbench.renderer.render", "user_annotation", 100.0, 200.0),
        ev("rtbench.engine.settle", "user_annotation", 20.0, 50.0),
        ev("rtbench.engine.update", "user_annotation", 500.0, 400.0),
        ev("rtbench.engine.settle", "user_annotation", 510.0, 50.0),
        ev("rtbench.renderer.render", "user_annotation", 600.0, 100.0),
        ev("void (anonymous namespace)::render_single<false>(Params)",
           "kernel", 200.0, 300.0, device=0),
        ev("void (anonymous namespace)::render_single<false>(Params)",
           "kernel", 600.0, 300.0, device=0),
        ev("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "AUnaryFunctor<float, float, float, at::native::binary_internal::"
           "MulFunctor<float> > >", "kernel", 500.0, 50.0, device=0),
        ev("Memcpy HtoD", "gpu_memcpy", 950.0, 10.0, device=0),
    ]


def traced():
    run = dict(events=timeline(), window_frames=2, window_segments=1000,
               width=4, height=2, window_s=0.001, devices=["cuda:0"],
               periods=[0.0004, 0.0006], setup_s=2.5)
    return harness.reading(run, dict(ops_per_segment=67.0,
                                     bytes_per_frame=0.0))


def test_busy_idle_and_breakdown():
    tr = traced()
    assert tr["window_us"] == (0.0, 1000.0)
    # 200-550 and 600-900 and 950-960: 660 us of 1000
    assert harness.busy_seconds(tr) == pytest.approx(660e-6)
    idle = manifest.reader("device.idle_pct").read(tr)
    assert idle == pytest.approx(34.0)
    b = harness.breakdown(tr)
    assert b["device_ops"][0][1] == pytest.approx(600e-6)
    assert b["idle_gaps"][0] == ["renderer.render", pytest.approx(200e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_span_and_kernel_readers():
    tr = traced()
    r = lambda name: manifest.reader(name).read(tr)
    assert r("engine.host_ms") == pytest.approx(0.4 - 0.15 - 0.05)
    assert r("renderer.dispatch_ms") == pytest.approx(0.15)
    assert r("renderer.blend_ms") == pytest.approx(0.025)
    assert r("megakernel.ns_per_segment") == pytest.approx(600.0)
    # 67,000 operations at 67 TFLOP/s: 1 ns of bound in 600 us
    assert r("megakernel_roofline") == pytest.approx(100 * 1e-9 / 600e-6)


def test_end_to_end_readers():
    rd = traced()
    r = lambda name: manifest.reader(name).read(rd)
    assert r("mrays_per_s") == pytest.approx(1.0)    # 1000 in 1 ms
    assert r("frame_ms_p95") == pytest.approx(0.59)
    assert r("setup_s") == 2.5
