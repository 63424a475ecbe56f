"""`repro_torch` command-line entry point: drive the port's Pipeline.

    python -m repro_torch profile  [--config cfg.json | --reduced]
                                   [--target cnn|lm|moe|scan] [--arch A]
                                   [--steps N] [--seed S] [--plan-out BASE]
                                   [--verify-cosim]
    python -m repro_torch compress [--config cfg.json | --reduced]
                                   [--target cnn|lm|moe|scan] [--arch A]
                                   [--steps N]
                                   [--search-mode MODE] [--compress-k K]
                                   [--seed S] [--plan-in BASE]
                                   [--plan-out BASE]
    python -m repro_torch export --plan-in BASE [--plan-out BASE2]
    python -m repro_torch serve  --plan-in BASE [--plan-out BASE2]
                                 [--mode engine|oneshot] [--requests N]
                                 [--prompt-len P] [--new-tokens T]
                                 [--mixed] [--max-batch B]
                                 [--temperature X] [--verify-oneshot]
                                 [--plans SPEC ...] [--plans-dir DIR]

``profile`` runs the CNN target through ``energy_model``: ``--steps`` steps
of QAT base training (``train.qat_steps``), the per-layer trace statistics
on the transition-statistics kernel, energy LUTs and shares. ``compress``
runs all five stages: profile, energy_model, the layer-wise ``schedule``
(weight selection inside QAT fine-tunes), ``export`` (packed 4-bit
artifacts) and ``serve`` (the full-model forward on the LUT GEMM); the JAX
package's ``compress`` stops after ``schedule``. The schedule runs the
config's ``search_mode``, the batched candidate sweep by default;
``--search-mode serial`` takes the serial walk, which makes the same
decisions. ``export`` and ``serve`` resume a saved plan, from either
package.

``--target lm`` compresses an LM of
`repro_torch.configs` (``--arch olmo-1b``; ``--reduced``: its scaled-down
form, no LM QAT, ``--compress-k 4``): profile (seeded parameters, then
``train.qat_steps`` of LM QAT, 300 by default, ``--steps N`` to override),
energy_model (the uniform-trace LUT), schedule (every matmul restricted to
the same k-value codebook) and export (packed 4-bit artifacts, one a layer).
For an LM target ``compress`` runs through ``export`` and prints one line
naming ``serve --plan-in`` for the serve stage; the JAX package's
``compress`` stops after ``schedule``. ``serve --plan-in`` on an LM plan
runs the serve stage: the continuous-batching engine drains a
deterministic request trace (the ``serve`` options override the plan's
``serve`` section; ``--verify-oneshot`` drains it through the oneshot
fallback too and records whether every token agrees). ``--plans SPEC
...`` / ``--plans-dir DIR`` serve a fleet instead of the plan's one
variant: every SPEC (``base``, ``k<N>[m<M>]``, or a saved plan's base path)
and every saved plan under DIR is a resident plan, and the fleet router
picks one per request from queue pressure and budgets. ``--target moe``
(``--arch phi3.5-moe-42b-a6.6b`` by default with ``--reduced``) and
``--target scan`` (``mamba2-1.3b``; or recurrentgemma-2b) are the routed LM
targets: the profile stage also measures each expert's dispatch traffic
or each scan layer's activity on a calibration trace, and the schedule
gives every unit the ``--compress-k`` floor, then each routed slice a
codebook size from the k ladder by its traffic rank; ``compress`` runs
them through ``export``, as an LM target. ``--compress-k`` applies to the
LM targets only (lm, moe, scan); with a CNN it is an error.
``--verify-cosim`` (every command) gates a CNN profile stage's transition
histograms, bin for bin, against the bit-accurate systolic cosim
(`repro_torch.cosim`) on the sampled tiles, and writes the ``cosim_*``
metrics to the plan; a stage that does not run (a resumed plan past
profile) and an LM target ignore it, as in the JAX package.
``--plan-in`` resumes a plan (completed stages are skipped), ``--plan-out``
saves the result as ``BASE.json`` + ``BASE.npz``. Every command takes
``--device``, which defaults to ``cuda``; on a host without CUDA that is an
error, and ``--device cpu`` runs the plain versions of the kernels instead.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

# subcommand -> last pipeline stage it runs
COMMAND_STAGE = {"profile": "energy_model", "compress": "serve",
                 "export": "export", "serve": "serve"}
CONFIG_COMMANDS = ("profile", "compress")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch",
        description="PyTorch/CUDA port of the compression pipeline "
                    "(profile -> energy_model -> schedule -> export -> "
                    "serve) over one CompressionPlan artifact.")
    sub = ap.add_subparsers(dest="command", required=True)
    for command, stage in COMMAND_STAGE.items():
        p = sub.add_parser(command,
                           help=f"run the pipeline through its '{stage}' "
                                "stage")
        if command in CONFIG_COMMANDS:
            p.add_argument("--config", default=None, metavar="JSON",
                           help="PipelineConfig JSON file")
            p.add_argument("--target", choices=("cnn", "lm", "moe", "scan"),
                           default=None,
                           help="target kind when building a config from "
                                "flags (moe/scan: the routed LM targets)")
            p.add_argument("--arch", default=None,
                           help="cnn: lenet5|resnet8|resnet20|resnet50; "
                                "lm/moe/scan: a repro_torch.configs id "
                                "(olmo-1b, phi3.5-moe-42b-a6.6b, "
                                "mamba2-1.3b)")
            p.add_argument("--reduced", action="store_true",
                           help="CPU-smoke preset (cnn: LeNet-5, tiny "
                                "budgets; lm: the scaled-down config)")
            p.add_argument("--compress-k", type=int, default=None,
                           help="lm/moe/scan: restrict every eligible "
                                "matmul to a k-value codebook (the routed "
                                "targets' floor)")
            p.add_argument("--steps", type=int, default=None,
                           help="override train.qat_steps")
            p.add_argument("--search-mode", choices=("batched", "serial"),
                           default=None,
                           help="override schedule.search_mode (both "
                                "make the same decisions)")
            p.add_argument("--seed", type=int, default=None,
                           help="override target.seed")
        p.add_argument("--plan-in", required=command not in CONFIG_COMMANDS,
                       default=None, metavar="BASE",
                       help="resume from a saved plan (BASE.json + BASE.npz)")
        p.add_argument("--plan-out", default=None, metavar="BASE",
                       help="save the resulting plan to BASE.json + BASE.npz")
        p.add_argument("--verify-cosim", action="store_true",
                       help="gate the profiler's transition histograms "
                            "against the bit-accurate systolic cosim "
                            "(repro_torch.cosim) on the sampled tiles")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where to run (default: cuda; an error on a "
                            "host without CUDA)")
        p.add_argument("--quiet", action="store_true",
                       help="suppress per-stage progress output")
        if command == "serve":
            p.add_argument("--mode", choices=("engine", "oneshot"),
                           default=None, help="override serve.mode")
            p.add_argument("--requests", type=int, default=None)
            p.add_argument("--prompt-len", type=int, default=None)
            p.add_argument("--new-tokens", type=int, default=None)
            p.add_argument("--mixed", action=argparse.BooleanOptionalAction,
                           default=None,
                           help="vary request lengths across buckets")
            p.add_argument("--max-batch", type=int, default=None,
                           help="engine wave width")
            p.add_argument("--temperature", type=float, default=None)
            p.add_argument("--verify-oneshot", action="store_true",
                           default=None,
                           help="cross-check engine tokens vs the oneshot "
                                "fallback")
            p.add_argument("--plans", nargs="+", default=None,
                           metavar="SPEC",
                           help="fleet serving: resident plan variants "
                                "routed across by load/budget. Each SPEC is "
                                "'base', 'k<N>[m<M>]' (k-value codebook + "
                                "MSR bits), or a saved CompressionPlan "
                                "base path")
            p.add_argument("--plans-dir", default=None, metavar="DIR",
                           help="fleet serving: load every saved "
                                "CompressionPlan under DIR as a resident "
                                "variant")
    return ap


def _serve_overrides(args) -> dict:
    fields = {
        "mode": getattr(args, "mode", None),
        "compress_k": getattr(args, "compress_k", None),
        "requests": getattr(args, "requests", None),
        "prompt_len": getattr(args, "prompt_len", None),
        "new_tokens": getattr(args, "new_tokens", None),
        "mixed": getattr(args, "mixed", None),
        "max_batch": getattr(args, "max_batch", None),
        "temperature": getattr(args, "temperature", None),
        "verify_oneshot": getattr(args, "verify_oneshot", None),
        "plans": (tuple(args.plans)
                  if getattr(args, "plans", None) else None),
        "plans_dir": getattr(args, "plans_dir", None),
    }
    return {k: v for k, v in fields.items() if v is not None}


def _overrides(args) -> dict:
    """Config overrides from the flags a resumed plan may still change."""
    over: dict = {}
    if getattr(args, "steps", None) is not None:
        over["train"] = {"qat_steps": args.steps}
    if getattr(args, "search_mode", None) is not None:
        over["schedule"] = {"search_mode": args.search_mode}
    if args.verify_cosim:
        over["profile"] = {"verify_cosim": True}
    serve = _serve_overrides(args)
    if serve:
        over["serve"] = serve
    return over


def _build_config(args):
    from repro_torch.pipeline.config import (
        PipelineConfig,
        reduced_cnn_config,
        reduced_lm_config,
        reduced_moe_config,
        reduced_scan_config,
    )

    kind = args.target
    if args.config:
        cfg = PipelineConfig.load(args.config)
    elif args.reduced:
        presets = {"lm": (reduced_lm_config, "olmo-1b"),
                   "moe": (reduced_moe_config, "phi3.5-moe-42b-a6.6b"),
                   "scan": (reduced_scan_config, "mamba2-1.3b")}
        if kind in presets:
            preset, arch = presets[kind]
            cfg = preset(args.arch or arch)
        else:
            cfg = reduced_cnn_config()
    else:
        cfg = PipelineConfig()
    overrides = _overrides(args)
    target = {k: v for k, v in (("kind", kind), ("arch", args.arch),
                                ("seed", args.seed)) if v is not None}
    if target:
        overrides["target"] = target
    return cfg.with_overrides(overrides)


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

    try:
        if args.plan_in:
            pipe = Pipeline.from_plan(CompressionPlan.load(args.plan_in),
                                      device=device)
            # flags still override the embedded config for the stages that
            # remain to run; the target identity is fixed by the plan
            pipe.cfg = pipe.cfg.with_overrides(_overrides(args))
        else:
            pipe = Pipeline(_build_config(args), device=device)
        if (getattr(args, "compress_k", None) is not None
                and pipe.cfg.target.kind == "cnn"):
            ap.error("--compress-k restricts an LM's codebooks: pass "
                     "--target lm, moe or scan")
        stage = COMMAND_STAGE[args.command]
        if args.command == "compress" and pipe.target.kind != "cnn":
            stage = "export"
            print("[repro_torch] compress runs an LM target through export; "
                  "run its serve stage with `serve --plan-in BASE` on the "
                  "saved plan")
        plan = pipe.run_until(stage, verbose=not args.quiet)
    except NotImplementedError as e:
        ap.error(str(e))
    print(json.dumps(plan.summary(), indent=2))
    if args.plan_out:
        json_path, npz_path = plan.save(args.plan_out)
        print(f"plan saved: {json_path} + {npz_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
