"""g++ builds of the port's host-side C++ (``accel/native``: the BVH
builder; ``assets/native``: the OBJ tokenizer).

A source is compiled at first use into the package's ``_build/`` directory,
named by a hash of the source and the flags, and written under a temporary
name before it is moved into place, so that processes building at once
never load half a library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

_BUILD = Path(__file__).resolve().parent / "_build"


def build_library(src: Path, stem: str, flags: list[str]) -> Path:
    """The shared library of ``src`` built with ``g++ flags``; raises
    ``RuntimeError`` with the compiler's output if it fails."""
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    so = _BUILD / f"{stem}_{tag}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    return so
