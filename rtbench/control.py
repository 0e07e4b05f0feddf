"""The readings the limits of ``correct`` are set from (``cells/<cell>.json``
``limits``)::

    python3 -m rtbench.control --workload <cell> --seconds <s> --seeds <n> ...

For each seed it runs the cell's window through the program as a run
does, then computes the reference in float32 and the control, the same
reference in bfloat16 (the nearest precision below the renderer's
float32), and prints one line per seed: the program's numbers against the
reference (the lower readings) and the control's (the upper readings).

With ``--fault <name>`` (``rtbench.faults``) it instead runs each seed as a
benchmark run does with that fault planted in the program's path, and
prints the numbers compared, their limits and ``correct``. A benchmark run
never runs the control or a fault.
"""
from __future__ import annotations

import argparse
import json
import time

from rtbench import faults, harness, manifest
from rtbench.reference import compare


def readings(cell_name: str, seed: int, seconds: float) -> dict:
    import torch
    device = "cuda"
    cell = manifest.cell(manifest.load(), cell_name)
    run, inputs = harness.drive(cell, seed, seconds, False, device)
    t0 = time.perf_counter()
    ref = compare.reference_outputs(inputs, run, device, torch.float32)
    t1 = time.perf_counter()
    ctl = compare.reference_outputs(inputs, run, device, torch.bfloat16)
    t2 = time.perf_counter()
    return dict(
        cell=cell_name, seed=seed, frames=run["n_frames"],
        program=compare.numbers(run["values"], ref["values"],
                                run["last_segments"], ref["segments"]),
        control=compare.numbers(ctl["values"], ref["values"],
                                ctl["segments"], ref["segments"]),
        reference_s=t1 - t0, control_s=t2 - t1)


def fault_readings(cell_name: str, seed: int, seconds: float,
                   fault: str) -> dict:
    hook = faults.plant(fault)
    try:
        out, run = harness.run_cell(cell_name, seed, seconds, False,
                                    hook=hook)
    finally:
        hook.undo()
    return dict(cell=cell_name, seed=seed, fault=fault,
                frames=run["n_frames"], correct=out["correct"],
                checks=out["checks"], reference_s=run["reference_s"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=faults.NAMES)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        if args.fault:
            line = fault_readings(args.workload, seed, args.seconds,
                                  args.fault)
        else:
            line = readings(args.workload, seed, args.seconds)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
