"""Run one cell of ``BENCHMARK.json`` once and print its result line::

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` a ``breakdown``, and the compared numbers with their limits
under ``checks``); the compared numbers also close standard error. The run
exits non-zero and prints no result when the card the cell asks for is not
there, or when the JAX stack or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from rtbench import manifest


def caches(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the port's own nvcc output lives in
    ``ray_tracer_2_tpu_torch/_build/``)."""
    base = root / ".rtbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    # one process with few threads: the frame loop's host work is serial
    os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = manifest.ROOT
    caches(root)
    cell = manifest.cell(manifest.load(root), args.workload)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"rtbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from rtbench import harness
    out, run = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace))
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"rtbench: loaded {', '.join(leaked)}, which the port must not",
              file=sys.stderr)
        return 4
    print(f"rtbench: {run['n_frames']} frames, reference "
          f"{run['reference_s']:.1f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
