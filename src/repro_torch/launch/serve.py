"""Serving launcher (port of `repro.launch.serve`): a thin CLI over the
port's pipeline with an LM target — seeded parameters or a checkpoint's
(``--ckpt-dir``), optionally every eligible matmul restricted to a k-value
codebook and the packed 4-bit artifacts exported, then a request trace
drained through `repro_torch.serving.ServingEngine`.

    python -m repro_torch.launch.serve --arch olmo-1b --reduced --device cpu

``--mode oneshot`` swaps the slot-level engine for the single-shot fallback
(batch-1 waves, one request at a time, same buckets and step cache); the
two are output-identical (the wave scheduler, ``mode="wave"`` of
`ServingEngine`, is not a serve-stage mode). ``--compress-k N`` restricts
every eligible matmul to an N-value codebook, exports the packed artifacts
and serves the compressed fake-quant forward. Runs on the card unless
``--device cpu``.

``--plans SPEC [SPEC ...]`` (or ``--plans-dir DIR``) serves a **fleet**
instead of one pinned variant: every SPEC becomes a resident
`repro_torch.serving.fleet.PlanHandle` (``base``, ``k4``, ``k8m2``, or a
saved CompressionPlan base path) and a `FleetRouter` picks the variant per
request from queue pressure and per-request budgets — degrading to
aggressive compression under load, recovering to high fidelity when idle:

    python -m repro_torch.launch.serve --arch olmo-1b --reduced \
        --plans k4 base --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch


def compress_report(model, params, k: int, *, block_k: int = 128,
                    check_units: int = 4, seed: int = 2):
    """Export eligible LM matmuls at codebook size ``k`` and verify parity.

    Standalone form of the pipeline's export stage
    (`repro_torch.pipeline.targets.LMTarget.stage_export`) for callers
    holding a bare (model, params): restricts every eligible matmul to a
    symmetric k-value codebook, exports the packed 4-bit artifacts, and
    checks the LUT GEMM against the fake-quant matmul on random activations
    for ``check_units`` units. Returns (artifacts, summary dict)."""
    from repro_torch._device import tree_leaves
    from repro_torch.core import lm_compress
    from repro_torch.core.export import export_summary

    device = tree_leaves(params)[0].device
    values = lm_compress.symmetric_codebook_values(k)
    comp = lm_compress.init_lm_comp(model, device=device)
    comp = lm_compress.restrict_all_codebooks(model, comp, values)
    arts, skips = lm_compress.export_lm_matmuls(model, params, comp,
                                                block_k=block_k)
    summary = export_summary(arts)
    summary["skipped_units"] = skips
    checked = lm_compress.lut_parity_report(model, params, comp, arts,
                                            check_units=check_units,
                                            seed=seed)
    summary["parity_checked"] = checked
    summary["parity_max_rel_err"] = max(checked.values()) if checked else 0.0
    return arts, summary


def generate(model, params, prompts: torch.Tensor, *, new_tokens: int,
             temperature: float = 0.0, seed: int = 0, q_block: int = 8,
             kv_block: int = 8) -> torch.Tensor:
    """Reference single-dispatch generation: prefill once (float32 cache),
    loop decode. Returns the (B, new_tokens) int tokens.

    Kept as the pre-engine serving path; the engine reproduces it exactly
    when a prompt fills its bucket (tested). Temperature draws come from a
    `torch.Generator` seeded with ``seed`` on the prompts' device (the JAX
    package draws with `jax.random`, which torch cannot reproduce)."""
    prompts = torch.as_tensor(prompts)
    vocab = model.cfg.vocab
    gen = torch.Generator(device=prompts.device).manual_seed(seed)

    def sample(lg):
        lg = lg[:, :vocab].float()
        if temperature <= 0:
            return lg.argmax(dim=-1)
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    with torch.no_grad():
        logits, cache = model.prefill(
            params, prompts, prompts.shape[1] + new_tokens,
            cache_dtype=torch.float32, q_block=q_block, kv_block=kv_block)
        tok = sample(logits[:, -1])[:, None].to(torch.int32)
        outs = [tok]
        for _ in range(new_tokens - 1):
            logits, cache = model.decode_step(params, cache, tok)
            tok = sample(logits[:, 0])[:, None].to(torch.int32)
            outs.append(tok)
    return torch.cat(outs, dim=1)


def trace_shapes(n_requests: int, prompt_len: int, new_tokens: int,
                 mixed: bool) -> list:
    """(prompt_len, new_tokens) per request; ``mixed`` varies lengths
    deterministically to exercise several buckets. Delegates to the
    pipeline's trace generator so the CLI and the serve stage agree."""
    from repro_torch.pipeline.targets import lm_trace_shapes

    return lm_trace_shapes(n_requests, prompt_len, new_tokens, mixed)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a CheckpointManager directory")
    ap.add_argument("--mode", choices=("engine", "oneshot"),
                    default="engine",
                    help="continuous-batching engine or single-shot fallback")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests in the trace")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--mixed", action="store_true",
                    help="vary request lengths across buckets")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="engine wave width")
    ap.add_argument("--compress-k", type=int, default=0,
                    help="restrict eligible matmuls to a k-value codebook, "
                         "export packed 4-bit artifacts and serve the "
                         "compressed forward")
    ap.add_argument("--plans", nargs="+", default=None, metavar="SPEC",
                    help="fleet serving: resident variants ('base', "
                         "'k<N>[m<M>]', or saved CompressionPlan base "
                         "paths) routed across by load and budget")
    ap.add_argument("--plans-dir", default=None, metavar="DIR",
                    help="fleet serving: load every saved CompressionPlan "
                         "under DIR as a resident variant")
    ap.add_argument("--plan-out", default=None, metavar="BASE",
                    help="save the CompressionPlan to BASE.json + BASE.npz")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: cuda; an error on a host "
                         "without CUDA)")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.pipeline.config import (
        PipelineConfig,
        ServeStageConfig,
        TargetConfig,
        TrainStageConfig,
    )
    from repro_torch.pipeline.pipeline import Pipeline

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    cfg = PipelineConfig(
        target=TargetConfig(kind="lm", arch=args.arch, reduced=args.reduced,
                            ckpt_dir=args.ckpt_dir),
        train=TrainStageConfig(qat_steps=0, final_finetune_steps=0),
        serve=ServeStageConfig(mode=args.mode, compress_k=args.compress_k,
                               plans=tuple(args.plans or ()),
                               plans_dir=args.plans_dir,
                               requests=args.batch,
                               prompt_len=args.prompt_len,
                               new_tokens=args.new_tokens, mixed=args.mixed,
                               max_batch=args.max_batch,
                               temperature=args.temperature),
    )
    try:
        pipe = Pipeline(cfg, device=device)
        plan = pipe.run_until("serve", verbose=True)
    except NotImplementedError as e:
        ap.error(str(e))
    m = plan.metrics

    print(f"serving {pipe.target.name}: {m['n_params'] / 1e6:.1f}M params")
    if args.compress_k:
        print(f"compressed export: {m['export_layers']} matmuls, "
              f"{m['export_weight_bytes_packed'] / 1e6:.2f} MB packed "
              f"({m['export_compression_vs_int8']:.2f}x vs int8), "
              f"LUT parity max rel err "
              f"{m['export_parity_max_rel_err']:.2e}")
    results = pipe.target.last_serve_results
    if m.get("serve_mode") == "fleet":
        rep = pipe.target.last_fleet_report
        print(f"fleet [{m['serve_plans']}]: {m['serve_requests']} requests "
              f"({m['serve_tokens_per_s']:.1f} tok/s), "
              f"{m['serve_level_degrades']} degrades / "
              f"{m['serve_level_recovers']} recovers, "
              f"{m['serve_recompiles_after_warmup']} recompiles after warmup")
        for pid, p in rep["plans"].items():
            print(f"  plan {pid}: {p['requests']} requests, "
                  f"{p['new_tokens']} tokens, {p['energy_eu']:.3g} eu")
        for tid, t in sorted(rep["tenants"].items()):
            print(f"  tenant {tid}: {t['requests']} requests, "
                  f"{t['new_tokens']} tokens, {t['energy_eu']:.3g} eu, "
                  f"SLO {t['slo_hits']}/{t['slo_total']}")
    else:
        print(f"{args.mode}: {m['serve_requests']} requests, "
              f"{m['serve_new_tokens']} tokens in {m['serve_wall_s']:.2f}s "
              f"({m['serve_tokens_per_s']:.1f} tok/s), "
              f"latency p50/p99 {m['serve_latency_p50_s'] * 1e3:.0f}/"
              f"{m['serve_latency_p99_s'] * 1e3:.0f} ms, "
              f"ttft p50 {m['serve_ttft_p50_s'] * 1e3:.0f} ms, "
              f"energy {m['serve_energy_eu_total']:.3g} eu "
              f"({m['serve_energy_eu_per_token']:.3g} eu/token), "
              f"{m['serve_cache_buckets_compiled']} buckets / "
              f"{m['serve_cache_compile_count']} builds")
    for rid in sorted(results)[:2]:
        print(f"  req{rid}: {results[rid].tokens[:10]}...")
    if args.plan_out:
        json_path, npz_path = plan.save(args.plan_out)
        print(f"plan saved: {json_path} + {npz_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
