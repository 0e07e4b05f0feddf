"""The PyTorch port imports without JAX and without the JAX package.

The card's machine has no JAX, and the JAX package's host side cannot be
imported without it, so the port (and ``chip_smoke.py``) must reach neither.
Each check runs in a fresh interpreter with ``jax`` blocked.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
import ray_tracer_2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "jaxlib", "ray_tracer_2_tpu"))
missing = {pkg.__name__ + "." + m
           for m in ("kernels.cuda_build", "kernels.megakernel",
                     "kernels.spheres", "probes.common", "probes.trav",
                     "probes.packet", "probes.r2", "probes.lut",
                     "probes.__main__")} - set(names)
print(len(names), leaked, sorted(missing))
"""


def _run(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    res = _run(_IMPORT_ALL)
    assert res.returncode == 0, res.stderr
    n, rest = res.stdout.split(" ", 1)
    assert int(n) >= 24, res.stdout          # every submodule was walked
    assert rest.strip() == "[] []", res.stdout   # no leak, kernels walked


def test_chip_smoke_refuses_without_a_card():
    """Here torch sees no CUDA device: the smoke run must fail and print no
    result."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
