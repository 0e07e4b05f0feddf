"""BENCHMARK.json against the benchmark's contract, and the files its
names lead to."""
import json
import re
import shutil

import pytest

from rtbench import harness, manifest, traffic

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
