#!/usr/bin/env python
"""Time the port's LM QAT train step on a CUDA card: a step's ms and peak
memory at full published width.

Cases (`CASES`): olmo-1b at 8 x 64 tokens (``launch.train``'s default
batch) and 64 x 64 (``compress --target lm``'s); recurrentgemma-2b at 8 x
64 and one (rglru, rglru, local) repeat, 3 of its 26 layers (the largest
read-out, 256,000 x 2,560; at 26 layers this step does not fit the 80 GB
card); mamba2-1.3b at its full depth and 8 x 64. Each runs the step of
the LM pipeline's QAT stage (`make_train_step`, QAT with comp, no remat,
128-wide attention blocks, lr 6e-4) on seeded parameters and
`SyntheticTokens` batches for `STEPS` steps: the median ms of the steps
after the first (host clock around a synchronized step), the losses, and
the peak bytes allocated during the steps.

    python3 tools/lm_qat_step_cost.py [--src DIR] [--tag NAME] [--arch A]

``--src`` is the ``src`` directory whose ``repro_torch`` runs (default this
checkout's), so that two trees, e.g. a parent commit unpacked beside this
one, compare in one session on one card; ``--arch`` (repeatable) keeps
that arch's cases only. Prints the card's name and power limit, then one
JSON line a case. Needs a CUDA card and ``nvcc`` (K3, the fake-quant
kernel, builds from the tree's sources at first use).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (arch, sequences of 64 tokens a step, layers: None for the published
# depth)
CASES = (("olmo-1b", 8, None), ("olmo-1b", 64, None),
         ("recurrentgemma-2b", 8, 3), ("mamba2-1.3b", 8, None))
STEPS = 5


def run_case(torch, arch, batch_size, n_layers):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.lm_compress import init_lm_comp
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch.train import (
        StepConfig,
        make_optimizer,
        make_train_step,
    )
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import init_params

    acfg = get_config(arch)
    if n_layers is not None:
        acfg = dataclasses.replace(acfg, n_layers=n_layers)
    model = build_lm(acfg)
    params = init_params(0, model.spec, "cuda")
    comp = init_lm_comp(model, device="cuda")
    cfg = StepConfig(qat=True, with_comp=True, remat=False, q_block=128,
                     kv_block=128, lr=6e-4)
    step = make_train_step(model, cfg)
    data = SyntheticTokens(vocab=model.cfg.vocab, seed=0)
    state = {"params": params, "opt": make_optimizer(cfg).init(params)}
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(STEPS):
        x, y = data.batch(i, batch_size, 64, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": x, "labels": y}, comp)
        losses.append(float(metrics["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(arch=arch, layers=model.cfg.n_layers,
                tokens=[batch_size, 64], steps=STEPS,
                step_ms=times, median_step_ms=statistics.median(times[1:]),
                losses=losses,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--arch", action="append")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("lm_qat_step_cost: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"[qat-step-cost] {args.tag} card {card}; repro_torch from "
          f"{Path(repro_torch.__file__).parent}", flush=True)
    torch.set_float32_matmul_precision("highest")
    for arch, batch_size, n_layers in CASES:
        if args.arch and arch not in args.arch:
            continue
        try:
            out = run_case(torch, arch, batch_size, n_layers)
        except torch.cuda.OutOfMemoryError as e:
            out = dict(arch=arch, layers=n_layers, tokens=[batch_size, 64],
                       error=f"out of memory: {str(e).splitlines()[0]}")
        out["tag"] = args.tag
        print("[qat-step-cost] " + json.dumps(out, sort_keys=True),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
