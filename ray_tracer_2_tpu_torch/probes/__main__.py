"""Run the Hopper probes at the TPU scripts' own sizes.

    python3 -m ray_tracer_2_tpu_torch.probes [name ...] [--device cuda|cpu]
                                             [--seed N]

Prints one JSON line per probe and size (the scripts' keys plus
``device_ms``, ``plain_ms``, ``library_ms``, ``bound_ms``, ``max_abs_err``,
``plain_equal`` and ``card``), a ``done`` line per probe, and exits
non-zero if any probe failed to build, launch or match its plain version.
The device is the card unless ``--device cpu`` is given, which runs the
plain versions; without a card it refuses.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ray_tracer_2_tpu_torch.probes import load_all


def main(argv=None) -> int:
    common = load_all()
    names = [n for n, _ in common.PROBES]
    ap = argparse.ArgumentParser(prog="python3 -m ray_tracer_2_tpu_torch."
                                      "probes", description=__doc__.split(
                                          "\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"probes to run (all by default): {names}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probes: no CUDA device (pass --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 2
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    ctx = common.Ctx(device=device, seed=args.seed,
                     card=common.card_name(device))
    common.emit("env", device=str(device), card=ctx.card,
                torch=torch.__version__, seed=args.seed)
    if device.type == "cuda":
        from ray_tracer_2_tpu_torch.kernels.cuda_build import build_all, \
            ptxas_lines
        kernels = [k for k, _ in common.KERNELS.values()]
        build_all(*kernels)
        for k in {k.source: k for k in kernels}.values():
            common.emit("build", source=k.source.name,
                        nvcc_seconds=k.build_seconds,
                        ptxas=ptxas_lines(k.build_log), card=ctx.card)
    return 0 if common.run(ctx, args.names) else 1


if __name__ == "__main__":
    sys.exit(main())
