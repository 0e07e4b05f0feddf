"""BENCHMARK.json against the benchmark's contract, and the files its
names lead to."""
import inspect
import json
import re
import shutil

import pytest

from rtbench import harness, manifest, traffic
from rtbench.frozen.work import small_scene_work
from test_rtbench_glass import SPONZA_BOUNDS, random_balls

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_names_and_units():
    m = manifest.load()
    assert set(m) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[part]]
        assert len(names) == len(set(names))
        for e in m[part]:
            assert set(e) - {"workloads"} == KEYS[part], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if e["unit"] == "%" and "roofline" in e["name"]:
            assert e["name"].endswith("_roofline")
    assert 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


def test_moves_and_cells_report_what_they_must():
    m = manifest.load()
    e2e = {e["name"] for e in m["end_to_end"]}
    for e in m["per_layer"]:
        assert e["moves"] in e2e
        for cell in e.get("workloads", []):
            names = {x["name"] for x in manifest.end_to_end(m, cell)}
            assert e["moves"] in names, (e["name"], cell)
    for w in m["workloads"]:
        names = {x["name"] for x in manifest.end_to_end(m, w["name"])}
        for e in manifest.per_layer(m, w["name"]):
            assert e["moves"] in names, (e["name"], w["name"])
    for w in m["workloads"]:
        names = {x["name"] for x in manifest.end_to_end(m, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert manifest.per_layer(m, w["name"])


def test_every_name_finds_its_files():
    m = manifest.load()
    root = manifest.ROOT
    for c in m["configs"]:
        assert c["file"].startswith("rtbench/") and (root / c["file"]).exists()
        assert (root / "rtbench" / "configs" / f"{c['name']}.py").exists()
        spec = manifest.config(m, c["name"])
        assert set(spec["reduced"]) == set(c["reduced"])
        assert len(c["source"]) <= 200
    for w in m["workloads"]:
        traffic.load(w["traffic"])
        data = manifest.cell_data(w["name"])
        assert set(data["limits"]) == {"mismatch_share", "mean_rel_err",
                                       "segments_gap"}
        assert data["work"]["ops_per_segment"] > 0
    assert m["command"][:3] == ["python3", "-m", "rtbench.run"]
    for p in m["paths"]:
        assert (root / p).is_dir() and not p.endswith("_torch")


def test_every_metric_has_a_reader():
    m = manifest.load()
    for e in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(e["name"]).read), e["name"]


def copy_of_the_benchmark(tmp_path):
    shutil.copytree(manifest.ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return manifest.load()


def test_a_new_mix_is_found_by_its_name_alone(tmp_path):
    """A mix added as a new data file and a new BENCHMARK.json entry, with
    no existing file edited, is found and driven (on the CPU, small), with
    the Engine parameters it sets."""
    m = copy_of_the_benchmark(tmp_path)
    (tmp_path / "rtbench" / "traffic" / "dummy_still.json").write_text(
        json.dumps(dict(name="dummy_still", loop="closed", dt=0.02,
                        warm_frames=1, params=dict(bounces=1, skybox=False),
                        why="test")))
    m["workloads"].append(dict(name="sponza268k.dummy_still",
                               config="sponza268k", traffic="dummy_still",
                               chips=1, why="test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    run, _ = harness.drive(manifest.cell(manifest.load(tmp_path),
                                         "sponza268k.dummy_still"),
                           seed=7, seconds=0.01, trace=False, device="cpu",
                           size=(16, 9), root=tmp_path)
    assert run["n_frames"] >= 2 and run["width"] == 16
    assert run["bounces"] == 1 and run["skybox"] is False


#: the per-layer metrics that read only the megakernel
MEGAKERNEL_ONLY = {"megakernel.ns_per_segment", "megakernel_roofline",
                   "megakernel.lane_occupancy",
                   "megakernel.rows_per_segment"}
#: the per-layer metrics each sponza cell reported before the four above
#: took a list of cells, and the host's own work a frame, which every
#: path's frame loop has
SPONZA_PER_LAYER = MEGAKERNEL_ONLY | {
    "engine.host_ms", "renderer.dispatch_ms", "renderer.blend_ms",
    "device.idle_pct", "engine.settle_wait_ms", "engine.camera_ms",
    "engine.relaunch_ms", "device.interframe_gap_ms", "engine.queued_pct",
    "engine.host_work_ms"}
SMALL_CELL = "random_balls.still"
#: the builder of a configuration on the small-scene path, as a later PR
#: would add it: upstream ``random_balls`` from its published rules
SMALL_BUILDER = ("import numpy as np\n\n\n" + inspect.getsource(random_balls)
                 + "\n\ndef inputs(spec, seed):\n"
                 "    return random_balls(spec['scene_seed'], spec['half'])\n")
#: its limits in the copy: those of ``test_random_balls_matches``, and
#: for ``mean_rel_err`` 0.02: on the CPU at 48x27, over the scenes of seeds
#: 42 and 1-7, sound runs read 0.0013-0.0072 and the bfloat16 control
#: 1.12-1.30
SMALL_LIMITS = dict(SPONZA_BOUNDS, mean_rel_err=0.02)


def small_scene_copy(root):
    """A copy of the benchmark under ``root`` with a configuration on the
    small-scene path and its still cell added by new files and new
    ``BENCHMARK.json`` entries alone: ``configs/random_balls.json`` and
    its builder, ``cells/random_balls.still.json``. Returns the copy's
    manifest."""
    m = copy_of_the_benchmark(root)
    rt = root / "rtbench"
    spec = dict(name="random_balls", reduced=[], scene_seed=42, half=11)
    (rt / "configs" / "random_balls.json").write_text(json.dumps(spec))
    (rt / "configs" / "random_balls.py").write_text(SMALL_BUILDER)
    (rt / "cells" / f"{SMALL_CELL}.json").write_text(json.dumps(dict(
        limits=SMALL_LIMITS,
        work=dict(ops_per_segment=small_scene_work(485, 0),
                  bytes_per_frame=1.0, **{"from": "test"}))))
    m["configs"].append(dict(
        name="random_balls",
        source="https://github.com/addiswebb/ray_tracer_2 "
               "src/scene/scene.rs:365-444",
        file="rtbench/configs/random_balls.json", reduced=[], why="test"))
    m["workloads"].append(dict(name=SMALL_CELL, config="random_balls",
                               traffic="still", chips=1, why="test"))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return manifest.load(root)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("small_scene")
    small_scene_copy(root)
    return root


def small_run(root, seed, monkeypatch, hook=None):
    """One run of the copy's small-scene cell on the CPU at 48x27 with no
    window beyond the mix's warm frames, every pixel compared; the scene
    is checked to take the small-scene path first."""
    from ray_tracer_2_tpu_torch.engine import renderer

    def route(eng):
        assert renderer.small_scene(eng.scene_manager.scene.scene)
        if hook is not None:
            hook(eng)
    monkeypatch.setattr(harness, "STILL_PIXELS", 48 * 27)
    out, run = harness.run_cell(SMALL_CELL, seed, 0.0, False, device="cpu",
                                size=(48, 27), root=root, hook=route)
    assert len(run["pixels"]) == 48 * 27 and run["n_frames"] == 5
    return out


def test_a_small_scene_cell_is_added_by_data_alone(small_root, monkeypatch):
    """A configuration whose frames take the small-scene kernel, added as
    data alone, reports every per-layer metric but the megakernel's four,
    and its run on the CPU is correct under its limits."""
    man = manifest.load(small_root)
    got = {x["name"] for x in manifest.per_layer(man, SMALL_CELL)}
    assert got == SPONZA_PER_LAYER - MEGAKERNEL_ONLY
    out = small_run(small_root, 2 ** 31 + 41, monkeypatch)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["sponza268k.still",
                                  "sponza268k.orbit1440"])
def test_each_sponza_cell_reports_the_same_metrics(cell):
    """The lists on the megakernel's four metrics leave the sponza cells
    with the 3 end-to-end and 13 per-layer metrics they reported before,
    and ``engine.host_work_ms`` beside them."""
    man = manifest.load()
    assert {x["name"] for x in manifest.per_layer(man, cell)} == \
        SPONZA_PER_LAYER
    assert {x["name"] for x in manifest.end_to_end(man, cell)} == \
        {"mrays_per_s", "frame_ms_p95", "setup_s"}


def test_a_new_end_to_end_metric_is_found_by_its_name_alone(tmp_path):
    """An end-to-end metric added as a reader and a BENCHMARK.json entry
    is read from the run's record like the others."""
    m = copy_of_the_benchmark(tmp_path)
    (tmp_path / "rtbench" / "metrics" / "frames_per_s.py").write_text(
        "def read(rd):\n    return rd['frames'] / rd['window_s']\n")
    m["end_to_end"].append(dict(name="frames_per_s", unit="1/s",
                                better="higher", bound=0.05,
                                source="host_clock"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    man = manifest.load(tmp_path)
    cell = manifest.cell(man, "sponza268k.still")
    run = dict(window_frames=40, window_segments=8_000_000, window_s=2.0,
               periods=[0.05] * 40, setup_s=3.0, width=16, height=9,
               events=None, devices=["cpu"], memory_peak_bytes=0)
    out = harness.result(man, cell, run, {}, True, False, root=tmp_path)
    assert out["metrics"]["frames_per_s"]["value"] == 20.0
    assert out["metrics"]["mrays_per_s"]["value"] == 4.0
    assert out["metrics"]["setup_s"]["value"] == 3.0


def test_a_mix_the_reference_cannot_replay_is_refused(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "nee_still.json").write_text(
        json.dumps(dict(name="nee_still", loop="closed", dt=0.02,
                        warm_frames=1, params=dict(nee=True), why="test")))
    with pytest.raises(ValueError, match="nee"):
        traffic.load("nee_still", tmp_path)
