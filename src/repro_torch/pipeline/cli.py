"""`repro_torch` command-line entry point: resume a saved plan on the card.

    python -m repro_torch export --plan-in BASE [--plan-out BASE2] [--device cpu]
    python -m repro_torch serve  --plan-in BASE [--plan-out BASE2] [--device cpu]

``export`` runs the plan's remaining stages through ``export`` (packed 4-bit
artifacts), ``serve`` through ``serve`` (the full-model forward on the LUT
GEMM, with logit parity against fake-quant). The plan's earlier stages
(profile, energy_model, schedule) come from the JAX package
(``python -m repro compress --plan-out BASE``) until the port has them.
``--device`` defaults to ``cuda``; on a host without CUDA that is an error,
and ``--device cpu`` runs the plain versions of the kernels instead.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

# subcommand -> last pipeline stage it runs
COMMAND_STAGE = {"export": "export", "serve": "serve"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch",
        description="PyTorch/CUDA port of the compression pipeline: resume "
                    "a saved CompressionPlan through export and serve.")
    sub = ap.add_subparsers(dest="command", required=True)
    for command, stage in COMMAND_STAGE.items():
        p = sub.add_parser(command,
                           help=f"run the plan through its '{stage}' stage")
        p.add_argument("--plan-in", required=True, metavar="BASE",
                       help="resume from a saved plan (BASE.json + BASE.npz)")
        p.add_argument("--plan-out", default=None, metavar="BASE",
                       help="save the resulting plan to BASE.json + BASE.npz")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where to run (default: cuda; an error on a "
                            "host without CUDA)")
        p.add_argument("--quiet", action="store_true",
                       help="suppress per-stage progress output")
    return ap


def main(argv: Optional[list] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    from repro_torch._device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))        # exits 2 with the message on stderr

    from repro_torch.pipeline.pipeline import Pipeline
    from repro_torch.pipeline.plan import CompressionPlan

    pipe = Pipeline.from_plan(CompressionPlan.load(args.plan_in),
                              device=device)
    plan = pipe.run_until(COMMAND_STAGE[args.command],
                          verbose=not args.quiet)
    print(json.dumps(plan.summary(), indent=2))
    if args.plan_out:
        json_path, npz_path = plan.save(args.plan_out)
        print(f"plan saved: {json_path} + {npz_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
