"""``BENCHMARK.json`` and the files its names lead to. Nothing here knows a
particular cell: a configuration, a traffic mix, a cell's frozen numbers
or a metric is found by its name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's data file, as ``BENCHMARK.json`` names it."""
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def builder(name: str, root: Path = ROOT):
    """The configuration's builder, ``configs/<name>.py``."""
    return module(root / "rtbench" / "configs" / f"{name}.py",
                  f"rtbench_config_{name}")


def cell_data(name: str, root: Path = ROOT) -> dict:
    """A cell's own frozen numbers, ``cells/<cell>.json`` (the limits that
    decide ``correct`` and the work a segment), or {} where it has none."""
    p = root / "rtbench" / "cells" / f"{name}.json"
    return json.loads(p.read_text()) if p.exists() else {}


def per_layer(manifest: dict, cell_name: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(manifest, cell_name)}
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def end_to_end(manifest: dict, cell_name: str) -> list:
    return [m for m in manifest["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str, root: Path = ROOT):
    """The metric's reader, ``metrics/<metric>.py``, end-to-end and
    per-layer alike: its ``read(reading)`` (``harness.reading``) returns the
    value, or None where it finds nothing."""
    return module(root / "rtbench" / "metrics" / f"{metric}.py",
                  "rtbench_metric_" + metric.replace(".", "_"))
