"""Hand-written Hopper counterparts of the repository's TPU probe kernels
(``scripts/probe_trav.py``, ``probe_packet.py``, ``probe_r2.py``,
``probe_lut.py``), run by ``python3 -m ray_tracer_2_tpu_torch.probes``.

Each module holds a script's probes: the probe functions (kernel on CUDA
tensors, plain PyTorch version on CPU tensors) and a runner per probe that
draws the script's inputs from a seed and prints one line per size. The
kernels live in ``csrc/probe_{trav,packet,r2,lut}.cu``.
"""
from __future__ import annotations

import importlib

#: the probe modules, in the order the entry point runs them
MODULES = ("trav", "packet", "r2", "lut")


def load_all():
    """Import every probe module (registering its probes and kernels), put
    the probes in ``MODULES`` order whatever imported them first, and
    return ``probes.common``."""
    for name in MODULES:
        importlib.import_module(f"{__name__}.{name}")
    common = importlib.import_module(f"{__name__}.common")
    common.PROBES.sort(key=lambda p: MODULES.index(
        p[1].__module__.rsplit(".", 1)[1]))
    return common
