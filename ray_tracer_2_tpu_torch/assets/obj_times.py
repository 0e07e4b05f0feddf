"""Load time of a large OBJ through the C++ tokenizer and through the Python
one.

    python3 -m ray_tracer_2_tpu_torch.assets.obj_times [--detail 10] [--reps 3]

Writes the procedural atrium (``sponza_builder.build_atrium``) at
``--detail`` (10: 268,224 triangles, about the real sponza's 262k) as one
OBJ, a ``usemtl`` group per part and ``v``/``vt``/``vn`` lines per corner,
into a temporary directory. Then builds the C++ tokenizer, checks that both
tokenizers give the same arrays and times, best of ``--reps``, each
tokenizer and the de-indexing both share (``load_obj`` is one tokenizer and
then that). Prints one JSON line; seconds on the host's CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np


def write_atrium_obj(path: Path, detail: int) -> int:
    """The atrium at ``detail`` as an OBJ file; returns its triangles."""
    from ray_tracer_2_tpu_torch.assets.sponza_builder import build_atrium
    tris = 0
    with open(path, "w") as f:
        for name, pos, nrm, uv in build_atrium(detail):
            f.write(f"o part_{name}\nusemtl {name}\n")
            np.savetxt(f, pos, fmt="v %.6f %.6f %.6f")
            np.savetxt(f, uv, fmt="vt %.6f %.6f")
            np.savetxt(f, nrm, fmt="vn %.6f %.6f %.6f")
            n = len(pos) // 3
            idx = np.arange(tris * 3 + 1, tris * 3 + 1 + 3 * n).reshape(n, 3)
            np.savetxt(f, np.repeat(idx, 3, axis=1),
                       fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
            tris += n
    return tris


def _best(fn, reps: int):
    out, best = None, float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def main(argv=None) -> int:
    from ray_tracer_2_tpu_torch.assets import native
    from ray_tracer_2_tpu_torch.assets.obj import _assemble, _parse_obj_python
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--detail", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "atrium.obj"
        tris = write_atrium_obj(path, args.detail)
        t0 = time.perf_counter()
        if native.get_lib() is None:
            raise RuntimeError("the C++ tokenizer did not build")
        build_s = time.perf_counter() - t0
        nat, nat_s = _best(lambda: native.parse_obj_native(path), args.reps)
        py, py_s = _best(lambda: _parse_obj_python(path), args.reps)
        same = all(np.array_equal(a, b) for a, b in zip(nat[:3], py[:3])) \
            and list(nat[3]) == list(py[3]) \
            and all(np.array_equal(nat[3][k], py[3][k]) for k in nat[3])
        if not same:
            raise RuntimeError("the tokenizers disagree")
        _, asm_s = _best(lambda: _assemble(*nat[:4]), args.reps)
        print(json.dumps(dict(
            detail=args.detail, triangles=tris,
            obj_bytes=path.stat().st_size, cpus=os.cpu_count(),
            build_s=build_s, native_tokenize_s=nat_s,
            python_tokenize_s=py_s, assemble_s=asm_s,
            load_obj_native_s=nat_s + asm_s, load_obj_python_s=py_s + asm_s,
            speedup_tokenize=py_s / nat_s, tokenizers_agree=same)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
