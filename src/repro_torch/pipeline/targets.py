"""Pipeline targets (port of `repro.pipeline.targets`).

A target owns the model runtime and implements one method per pipeline
stage; each takes the shared `CompressionPlan` and the `PipelineConfig` and
mutates only the plan. The CNN target's five stages are ported operation for
operation: ``profile`` (QAT base training, then the trace statistics),
``energy_model``, ``schedule`` (both search modes, the batched candidate
sweep by default), ``export`` and ``serve``. The LM target's five are
ported too (`LMTarget`): parameter initialisation or a checkpoint restore
followed by ``train.qat_steps`` of LM QAT, the uniform-trace energy model,
the uniform k-value codebook restriction, the export of packed artifacts,
and the serve stage (the continuous-batching engine over a deterministic
trace, pinned to one plan or routed across a fleet of resident plans).
The routed targets (`MoETarget`, `ScanTarget`) are LM targets whose profile
stage also measures the traffic through each routed unit on a calibration
trace (`repro_torch.core.routing_stats`), whose energy model weighs each
unit's energy by that share, and whose schedule gives hot units larger
codebooks from the k ladder than cold ones. With ``profile.verify_cosim``
the CNN target's profile stage also gates the transition-statistics kernel
against the bit-accurate systolic cosim (`repro_torch.cosim`) on the tiles
the statistics came from.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import tree_to
from repro_torch.core import lm_compress
from repro_torch.core import routing_stats as rs
from repro_torch.core.energy_lut import uniform_trace_lut
from repro_torch.core.export import export_model, export_summary
from repro_torch.core.runner import CnnRunner
from repro_torch.core.schedule import energy_prioritized_compression
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticImages, SyntheticTokens
from repro_torch.models.lm import build_lm
from repro_torch.nn.cnn import CNN_FACTORIES
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import init_params, spec_count
from repro_torch.pipeline.config import PipelineConfig
from repro_torch.pipeline.plan import CompressionPlan, decision_dict
from repro_torch.serving import metrics as serve_metrics


def resolve_target(cfg: PipelineConfig, device: torch.device):
    kinds = {"cnn": CnnTarget, "lm": LMTarget, "moe": MoETarget,
             "scan": ScanTarget}
    if cfg.target.kind not in kinds:
        raise ValueError(f"unknown target kind {cfg.target.kind!r}")
    return kinds[cfg.target.kind](cfg, device)


def lm_trace_shapes(n_requests: int, prompt_len: int, new_tokens: int,
                    mixed: bool, *, stride: int = 7) -> List[Tuple[int, int]]:
    """Deterministic (prompt_len, new_tokens) trace; ``mixed`` varies lengths
    so several buckets are exercised."""
    if not mixed:
        return [(prompt_len, new_tokens)] * n_requests
    lens = [max(2, prompt_len - stride * (i % 3)) for i in range(n_requests)]
    news = [max(2, new_tokens - 3 * (i % 2)) for i in range(n_requests)]
    return list(zip(lens, news))


def lm_serve_trace(serve, vocab: int):
    """(shapes, `EngineConfig`, [`ServeRequest`]) of the serve stage's
    deterministic trace for a ``ServeStageConfig``: prompt buckets at half
    and all of the longest prompt, one new-token bucket, and request i's
    prompt drawn by ``np.random.default_rng(prompt_seed + i)``."""
    from repro_torch.serving import EngineConfig, ServeRequest

    s = serve
    shapes = lm_trace_shapes(s.requests, s.prompt_len, s.new_tokens,
                             s.mixed, stride=s.mixed_stride)
    p_bucket = max(sh[0] for sh in shapes)
    n_bucket = max(sh[1] for sh in shapes)
    # dedupe and sort: EngineConfig rejects duplicate buckets, and a tiny
    # p_bucket makes the half-size bucket collide with it
    p_buckets = tuple(sorted({max(p_bucket // 2, 2), p_bucket}))
    ecfg = EngineConfig(max_batch=s.max_batch, prompt_buckets=p_buckets,
                        new_token_buckets=(n_bucket,))
    requests = [
        ServeRequest(tokens=np.random.default_rng(s.prompt_seed + i)
                     .integers(0, vocab, plen).astype(np.int32),
                     max_new_tokens=ntok, temperature=s.temperature,
                     tenant=f"tenant{i % 2}")
        for i, (plen, ntok) in enumerate(shapes)]
    return shapes, ecfg, requests


class CnnTarget:
    """CNN compression through a `repro_torch.core.runner.CnnRunner` on one
    device. An injected ``runner`` (its model, dataset and device) replaces
    the one the config describes."""

    kind = "cnn"

    def __init__(self, cfg: PipelineConfig, device: torch.device,
                 runner: Optional[CnnRunner] = None):
        if runner is None:
            t = cfg.target
            runner = CnnRunner(CNN_FACTORIES[t.arch](),
                               SyntheticImages(seed=t.data_seed),
                               batch_size=t.batch_size, lr=t.lr, seed=t.seed,
                               device=device)
        self.runner = runner
        self.model = runner.model
        self.dataset = runner.dataset
        self.batch_size = runner.batch_size
        self.device = runner.device
        self.name = self.model.name

    def _on_device(self, plan: CompressionPlan) -> None:
        """Move the plan's tensors to this target's device (plans load on
        the CPU)."""
        plan.params = tree_to(plan.params, self.device)
        plan.state = tree_to(plan.state, self.device)
        plan.comp = tree_to(plan.comp, self.device)
        plan.opt_state = tree_to(plan.opt_state, self.device)
        if plan.stats:
            plan.stats = {n: s.to(self.device) for n, s in plan.stats.items()}
        if plan.artifacts:
            plan.artifacts = {k: a.to(self.device)
                              for k, a in plan.artifacts.items()}

    # ------------------------------------------------------------- stages

    def stage_profile(self, plan: CompressionPlan, cfg: PipelineConfig,
                      verbose: bool = False) -> None:
        """Fresh parameters, ``train.qat_steps`` of QAT base training,
        base accuracy, then the per-layer trace statistics (one K1 launch
        per compressible layer on the card). With ``profile.verify_cosim``
        the same layers' sampled tiles go through K1 again and through the
        cosim (`repro_torch.cosim.verify_runner_profile`): the ``cosim_*``
        metrics, and `RuntimeError` naming the layers whose histograms
        differ."""
        runner = self.runner
        params, state, opt_state, comp = runner.init()
        loss = float("nan")
        if cfg.train.qat_steps:
            params, state, opt_state, loss = runner.train(
                params, state, opt_state, comp, cfg.train.qat_steps)
        acc_base = runner.accuracy(params, state, comp,
                                   n_batches=cfg.train.eval_batches)
        if verbose:
            print(f"[pipeline] QAT base: loss={loss:.4f} acc={acc_base:.3f}")
        stats = runner.profile(params, state, comp,
                               n_batches=cfg.profile.batches,
                               max_tiles=cfg.profile.max_tiles)
        plan.params, plan.state = params, state
        plan.opt_state, plan.comp = opt_state, comp
        plan.stats = stats
        plan.metrics["acc_base"] = float(acc_base)
        plan.metrics["qat_loss"] = float(loss)
        if cfg.profile.verify_cosim:
            from repro_torch.cosim import verify_runner_profile

            res = verify_runner_profile(
                runner, params, state, comp,
                n_batches=cfg.profile.batches,
                max_tiles=cfg.profile.max_tiles)
            plan.metrics["cosim_match"] = bool(res["match"])
            plan.metrics["cosim_tiles"] = int(res["n_tiles"])
            plan.metrics["cosim_max_abs_diff"] = float(res["max_abs_diff"])
            plan.metrics["cosim_toggles"] = int(res["toggles"])
            if verbose:
                print(f"[pipeline] cosim verify: match={res['match']} "
                      f"tiles={res['n_tiles']} "
                      f"max_abs_diff={res['max_abs_diff']}")
            if not res["match"]:
                bad = {n: r["max_abs_diff"] for n, r in res["layers"].items()
                       if not r["match"]}
                raise RuntimeError(
                    "transition-statistics kernel disagrees with the "
                    f"bit-accurate cosim on layers {bad}")

    def stage_energy_model(self, plan: CompressionPlan, cfg: PipelineConfig,
                           verbose: bool = False) -> None:
        self._on_device(plan)
        models = self.runner.energy_models(plan.params, plan.comp, plan.stats)
        e_total = sum(m.energy for m in models.values())
        plan.shares = {n: m.energy / max(e_total, 1e-12)
                       for n, m in models.items()}
        plan.luts = {n: m.lut for n, m in models.items()}
        plan.metrics["energy_profile_total"] = float(e_total)
        if verbose:
            for n, s in sorted(plan.shares.items(), key=lambda kv: -kv[1]):
                print(f"[pipeline] energy share {n}: {s:.3f}")

    def stage_schedule(self, plan: CompressionPlan, cfg: PipelineConfig,
                       verbose: bool = False) -> None:
        """The energy-prioritized layer-wise schedule (``search_mode``:
        the batched candidate sweep or the serial walk), the final
        fine-tune, and the decisions and metrics of the JAX stage."""
        self._on_device(plan)
        runner = self.runner
        params, state, opt_state, comp, sched = energy_prioritized_compression(
            runner, plan.params, plan.state, plan.opt_state, plan.comp,
            plan.stats, cfg.schedule, cfg.selection, verbose=verbose)
        if cfg.train.final_finetune_steps:
            params, state, opt_state, _ = runner.train(
                params, state, opt_state, comp,
                cfg.train.final_finetune_steps)
        acc_final = runner.accuracy(params, state, comp,
                                    n_batches=cfg.train.eval_batches)
        models = runner.refresh_counts(
            params, comp, runner.energy_models(params, comp, plan.stats))
        e_after = sum(m.energy for m in models.values())

        plan.params, plan.state = params, state
        plan.opt_state, plan.comp = opt_state, comp
        plan.decisions = [decision_dict(d) for d in sched.decisions]
        ks = [int(d.k) for d in sched.decisions if d.k is not None]
        plan.metrics.update({
            "acc0": float(sched.acc0),
            "acc_final": float(acc_final),
            "accuracy_drop": float(plan.metrics.get("acc_base", sched.acc0)
                                   - acc_final),
            "energy_before": float(sched.energy_before),
            "energy_after": float(e_after),
            "energy_saving": 1.0 - float(e_after)
            / max(float(sched.energy_before), 1e-12),
            "max_codebook": max(ks) if ks else 256,
        })
        if verbose:
            print(f"[pipeline] schedule: acc {sched.acc0:.3f} -> "
                  f"{acc_final:.3f}, energy saving "
                  f"{plan.metrics['energy_saving']:.3f}")

    def stage_export(self, plan: CompressionPlan, cfg: PipelineConfig,
                     verbose: bool = False) -> None:
        self._on_device(plan)
        arts = export_model(self.model, plan.params, plan.comp,
                            block_k=cfg.export.block_k)
        plan.artifacts = arts
        plan.metrics.update(
            {f"export_{k}": v for k, v in export_summary(arts).items()})
        if verbose:
            print(f"[pipeline] exported {len(arts)} compressed layers")

    def stage_serve(self, plan: CompressionPlan, cfg: PipelineConfig,
                    verbose: bool = False) -> None:
        """Full-model forward through the packed LUT GEMM: logit parity vs
        the QAT fake-quant reference + served accuracy.

        ``cfg.serve.use_ref_kernel`` is read for the `QuantConfig` only: CPU
        tensors take the plain LUT GEMM and CUDA tensors always launch the
        kernel, whatever the flag says. Both forwards' products are correctly
        rounded float32 (`exact_matmul`: float64 sums, so no TF32 setting
        applies), which keeps their activation quantization in step."""
        self._on_device(plan)
        arts = plan.artifacts or {}
        plan.metrics["serve_layers"] = len(arts)
        if not arts:
            if verbose:
                print("[pipeline] no layer is servable; nothing to serve")
            return
        model, dev = self.model, self.device
        qserve = QuantConfig.serve(use_ref_kernel=cfg.serve.use_ref_kernel)
        with torch.no_grad():
            x, _ = self.dataset.batch(0, self.batch_size, "val", device=dev)
            l_fake, _ = model.apply(plan.params, plan.state, x, train=False,
                                    qcfg=QuantConfig.on(), comp=plan.comp)
            l_serve, _ = model.apply(plan.params, plan.state, x, train=False,
                                     qcfg=qserve, comp=plan.comp, serve=arts)
            rel = float(torch.linalg.norm(l_serve - l_fake)
                        / torch.clamp(torch.linalg.norm(l_fake), min=1e-9))
            correct = 0
            n_batches = max(cfg.train.eval_batches, 1)
            for i in range(n_batches):
                xb, yb = self.dataset.batch(i, self.batch_size, "val",
                                            device=dev)
                logits, _ = model.apply(plan.params, plan.state, xb,
                                        train=False, qcfg=qserve,
                                        comp=plan.comp, serve=arts)
                correct += int((logits.argmax(-1) == yb).sum())
        plan.metrics["serve_logit_rel_err"] = rel
        plan.metrics["serve_accuracy"] = correct / (n_batches
                                                    * self.batch_size)
        if verbose:
            print(f"[pipeline] serve: {len(arts)} layers on the LUT GEMM, "
                  f"rel_err={rel:.2e}, "
                  f"acc={plan.metrics['serve_accuracy']:.3f}")


# ====================================================================== LM


class LMTarget:
    """LM compression and serving (port of
    `repro.pipeline.targets.LMTarget`) on one device. The model is
    `build_lm` of the config's architecture, scaled down where
    ``target.reduced``. ``data`` is the LM QAT's token stream: any object
    with ``batch(step, batch_size, seq_len, *, device) -> (tokens,
    labels)``, `SyntheticTokens` of ``target.data_seed`` unless replaced."""

    kind = "lm"

    def __init__(self, cfg: PipelineConfig, device: torch.device):
        acfg = get_config(cfg.target.arch)
        if cfg.target.reduced:
            acfg = acfg.scaled_down(compute_dtype="float32")
        self.acfg = acfg
        self.model = build_lm(acfg)
        self.name = acfg.name
        self.device = device
        self.data = SyntheticTokens(vocab=acfg.vocab,
                                    seed=cfg.target.data_seed)
        self._unit_energy_cache: Optional[Dict[str, float]] = None
        self.last_serve_results: Dict = {}
        self.last_fleet_report: Optional[dict] = None
        self.last_qat: Dict[str, list] = {"loss": [], "step_s": []}

    def _on_device(self, plan: CompressionPlan) -> None:
        """Move the plan's tensors to this target's device (plans load on
        the CPU)."""
        plan.params = tree_to(plan.params, self.device)
        plan.comp = tree_to(plan.comp, self.device)
        if plan.artifacts:
            plan.artifacts = {k: a.to(self.device)
                              for k, a in plan.artifacts.items()}

    def _unit_energies(self, params, comp) -> Dict[str, float]:
        """Per-unit one-token MAC energy on the 64x64 array, priced with
        the uniform-trace LUT (no profiled activations exist at LM scale):
        `repro_torch.serving.metrics.unit_energies`, the sum the serving
        engine's per-token energy takes."""
        lut = uniform_trace_lut(device=self.device)
        return {name: float(e) for name, e in serve_metrics.unit_energies(
            self.model, params, comp, lut).items()}

    # ------------------------------------------------------------- stages

    def stage_profile(self, plan: CompressionPlan, cfg: PipelineConfig,
                      verbose: bool = False) -> None:
        """Parameters: restored from ``target.ckpt_dir`` (its ``params``
        subtree when the checkpoint holds a train state), else the plan's
        own (a plan of either package), else seeded (``target.seed``);
        then ``train.qat_steps`` of LM QAT (`_qat_train`) and the identity
        comp tree."""
        if cfg.target.ckpt_dir:
            from repro_torch.checkpoint.manager import CheckpointManager

            step, state = CheckpointManager(cfg.target.ckpt_dir).restore(
                device=self.device)
            params = state["params"] if "params" in state else state
            if verbose:
                print(f"[pipeline] restored checkpoint step {step}")
        elif plan.params is None:
            params = init_params(cfg.target.seed, self.model.spec,
                                 self.device)
        else:
            params = tree_to(plan.params, self.device)
        comp = lm_compress.init_lm_comp(self.model, device=self.device)
        if cfg.train.qat_steps:
            params = self._qat_train(params, comp, cfg, verbose)
        plan.params, plan.comp = params, comp
        plan.metrics["n_params"] = int(spec_count(self.model.spec))
        plan.metrics["n_units"] = len(lm_compress.lm_comp_layers(self.model))
        if verbose:
            print(f"[pipeline] {self.name}: "
                  f"{plan.metrics['n_params'] / 1e6:.1f}M params, "
                  f"{plan.metrics['n_units']} compressible units")

    def _qat_train(self, params, comp, cfg: PipelineConfig, verbose: bool):
        """LM QAT through the `repro_torch.launch.train` step factories:
        the JAX stage's settings (QAT with the comp tree, no remat, 128-wide
        attention blocks, ``target.lr``), ``target.batch_size`` sequences
        of 64 tokens a step from ``data``. The forward keeps the JAX
        package's numerics (`QuantConfig.batch_invariant` off). Each step's
        loss and wall time (the loss read back, so the step has finished)
        are kept in ``last_qat``."""
        from repro_torch.launch.train import (
            StepConfig,
            make_optimizer,
            make_train_step,
        )

        if self.acfg.encoder_decoder:
            # the JAX stage feeds tokens only and its forward asserts
            raise ValueError(
                f"{self.name}: LM QAT feeds token batches only, and an "
                "encoder-decoder model's forward needs enc_embeds; run "
                "compress with --steps 0, or train through "
                "launch.train.make_train_step with an enc_embeds batch")

        step_cfg = StepConfig(qat=True, with_comp=True, remat=False,
                              q_block=128, kv_block=128, lr=cfg.target.lr)
        train_step = make_train_step(self.model, step_cfg)
        state = {"params": params,
                 "opt": make_optimizer(step_cfg).init(params)}
        self.last_qat = {"loss": [], "step_s": []}
        loss = float("nan")
        for i in range(cfg.train.qat_steps):
            t0 = time.perf_counter()
            x, y = self.data.batch(i, cfg.target.batch_size, 64,
                                   device=self.device)
            state, metrics = train_step(state, {"tokens": x, "labels": y},
                                        comp)
            loss = float(metrics["loss"])
            self.last_qat["loss"].append(loss)
            self.last_qat["step_s"].append(time.perf_counter() - t0)
        if verbose:
            print(f"[pipeline] LM QAT: {cfg.train.qat_steps} steps, "
                  f"final loss={loss:.3f}")
        return state["params"]

    def stage_energy_model(self, plan: CompressionPlan, cfg: PipelineConfig,
                           verbose: bool = False) -> None:
        self._on_device(plan)
        energies = self._unit_energies(plan.params, plan.comp)
        total = sum(energies.values())
        plan.shares = {n: e / max(total, 1e-12) for n, e in energies.items()}
        plan.luts = {"uniform": uniform_trace_lut(device=self.device)}
        plan.metrics["energy_per_token"] = float(total)
        self._unit_energy_cache = energies

    def stage_schedule(self, plan: CompressionPlan, cfg: PipelineConfig,
                       verbose: bool = False) -> None:
        """Restrict every unit to the same ``serve.compress_k``-value
        symmetric codebook (0: leave the model unrestricted)."""
        self._on_device(plan)
        k = cfg.serve.compress_k
        e_before = self._unit_energy_cache
        if e_before is None:
            e_before = self._unit_energies(plan.params, plan.comp)
        total_before = sum(e_before.values())
        if not k:
            plan.metrics["energy_before"] = float(total_before)
            plan.metrics["energy_after"] = float(total_before)
            return
        plan.comp = lm_compress.restrict_all_codebooks(
            self.model, plan.comp, lm_compress.symmetric_codebook_values(k))
        e_after = self._unit_energies(plan.params, plan.comp)
        plan.decisions = [
            {"layer": name, "share": e_before[name] / max(total_before, 1e-12),
             "prune_ratio": None, "k": k,
             "energy_before": e_before[name], "energy_after": e_after[name],
             "accuracy": None, "accepted": True, "tried": [[0.0, k]]}
            for name in e_before
        ]
        plan.metrics["energy_before"] = float(total_before)
        plan.metrics["energy_after"] = float(sum(e_after.values()))
        plan.metrics["compress_k"] = k
        if verbose:
            print(f"[pipeline] restricted {len(e_before)} units to "
                  f"{k}-value codebooks "
                  f"(per-token energy {total_before:.3g} -> "
                  f"{plan.metrics['energy_after']:.3g} eu)")

    def stage_export(self, plan: CompressionPlan, cfg: PipelineConfig,
                     verbose: bool = False) -> None:
        """Packed 4-bit artifacts of every restricted unit (one a layer of
        a stacked unit, keyed ``blocks/g0/attn/wq[3]``), the skip report,
        and the LUT-GEMM parity of the first four units."""
        self._on_device(plan)
        arts, skips = lm_compress.export_lm_matmuls(
            self.model, plan.params, plan.comp, block_k=cfg.export.block_k)
        plan.artifacts = arts
        summary = export_summary(arts)
        checked = lm_compress.lut_parity_report(self.model, plan.params,
                                                plan.comp, arts)
        summary["parity_max_rel_err"] = max(checked.values()) if checked \
            else 0.0
        summary["skipped"] = len(skips)
        plan.metrics.update({f"export_{k}": v for k, v in summary.items()})
        if plan.stats is None:
            plan.stats = {}
        plan.stats.setdefault("export", {})["skip_report"] = skips
        if verbose and arts:
            print(f"[pipeline] exported {summary['layers']} matmuls, "
                  f"{summary['weight_bytes_packed'] / 1e6:.2f} MB packed "
                  f"({summary['compression_vs_int8']:.2f}x vs int8), "
                  f"LUT parity max rel err "
                  f"{summary['parity_max_rel_err']:.2e}")
        if verbose and skips:
            print(f"[pipeline] export skipped {len(skips)} units:")
            for sk in skips:
                print(f"  - {sk['unit']}: {sk['reason']} ({sk['detail']})")

    def _serve_handle(self, plan: CompressionPlan, k: int):
        """The single-variant `PlanHandle` the pinned serve stage uses."""
        from repro_torch.serving import PlanHandle

        if k and plan.comp is not None:
            return PlanHandle.from_comp(plan.comp, compress_k=k,
                                        plan_id=f"k{k}")
        if k:
            return PlanHandle.from_compress_k(self.model, k,
                                              device=self.device)
        return PlanHandle.uncompressed()

    def _fleet_handles(self, plan: CompressionPlan, cfg: PipelineConfig):
        """Resolve ``serve.plans`` specs and ``serve.plans_dir`` into a
        `PlanRegistry`: every saved plan under the directory, then each
        spec (``base``, ``k<N>[m<M>]``, or a saved plan's base path)."""
        from repro_torch.pipeline.config import parse_plan_spec
        from repro_torch.serving import PlanHandle, PlanRegistry

        registry = PlanRegistry()
        if cfg.serve.plans_dir:
            for h in PlanRegistry.from_dir(cfg.serve.plans_dir):
                registry.register(h)
        for spec in cfg.serve.plans:
            k, msr = parse_plan_spec(spec)
            if k is None:
                loaded = CompressionPlan.load(spec)
                registry.register(PlanHandle.from_compression_plan(loaded))
            elif k == 0:
                registry.register(PlanHandle.uncompressed())
            else:
                registry.register(PlanHandle.from_compress_k(
                    self.model, k, msr_bits=msr, device=self.device))
        return registry

    def stage_serve(self, plan: CompressionPlan, cfg: PipelineConfig,
                    verbose: bool = False) -> None:
        """Drain a deterministic request trace through the serving engine
        (``serve.mode``), on the fake-quant forward of the plan's comp tree
        when ``serve.compress_k`` (one K3 launch a step) and uncompressed
        otherwise, as the JAX stage does (it never sets ``lut_serve``). With
        ``verify_oneshot`` the oneshot fallback drains the same trace and
        ``serve_parity_engine_vs_oneshot`` records whether every request's
        tokens agree; ``serve_recompiles_after_warmup`` counts step builds
        after warmup. With ``serve.plans`` / ``serve.plans_dir`` the trace
        is routed across a fleet instead (`_serve_fleet`).

        Prompts (`lm_serve_trace`): request i draws
        ``np.random.default_rng(prompt_seed + i).integers(0, vocab,
        prompt_len)``. The JAX stage draws with
        ``jax.random.randint(PRNGKey(prompt_seed + i))``, which torch cannot
        reproduce, so the two stages serve different prompts; tests inject
        the same prompts into both packages."""
        from repro_torch.serving import ServingEngine

        self._on_device(plan)
        s = cfg.serve
        shapes, ecfg, requests = lm_serve_trace(s, self.acfg.vocab)
        if s.plans or s.plans_dir:
            self._serve_fleet(plan, cfg, ecfg, shapes, requests, verbose)
            return
        handle = self._serve_handle(plan, s.compress_k)

        def drain(mode):
            engine = ServingEngine(self.model, plan.params, mode=mode,
                                   config=ecfg, plan=handle,
                                   device=self.device)
            engine.warmup(shapes)
            warm_builds = engine.cache.compile_count
            results = engine.serve(requests)
            rep = engine.report()
            rep["recompiles_after_warmup"] = (engine.cache.compile_count
                                              - warm_builds)
            return {r.rid: r for r in results}, rep

        results, rep = drain(s.mode)
        plan.metrics.update({f"serve_{key}": val for key, val in rep.items()
                             if isinstance(val, (int, float, bool))})
        plan.metrics["serve_mode"] = s.mode
        parity: Optional[bool] = None
        if s.verify_oneshot and s.mode == "engine":
            ref, _ = drain("oneshot")
            parity = all(results[r].tokens == ref[r].tokens for r in results)
            plan.metrics["serve_parity_engine_vs_oneshot"] = bool(parity)
        self.last_serve_results = results
        if verbose:
            line = (f"[pipeline] {s.mode}: {rep['requests']} requests, "
                    f"{rep['new_tokens']} tokens "
                    f"({rep['tokens_per_s']:.1f} tok/s), "
                    f"{rep['recompiles_after_warmup']} recompiles after "
                    f"warmup")
            if parity is not None:
                line += f", engine==oneshot: {parity}"
            print(line)

    def _serve_fleet(self, plan: CompressionPlan, cfg: PipelineConfig, ecfg,
                     shapes, requests, verbose: bool) -> None:
        """Fleet path: route the trace across every resident plan
        (`FleetRouter`; ``mode="oneshot"`` becomes ``"engine"`` for a fleet,
        as in the JAX stage). Metrics: the fleet report's scalars as
        ``serve_*``, ``serve_mode = "fleet"`` and ``serve_plans``, the plan
        ids by level."""
        from repro_torch.serving import FleetRouter

        s = cfg.serve
        registry = self._fleet_handles(plan, cfg)
        fleet = FleetRouter(self.model, plan.params, registry,
                            mode=s.mode if s.mode != "oneshot" else "engine",
                            config=ecfg, device=self.device)
        fleet.warmup(shapes)
        results = fleet.serve(requests)
        rep = fleet.report()
        plan.metrics.update({f"serve_{key}": val for key, val in rep.items()
                             if isinstance(val, (int, float, bool))})
        plan.metrics["serve_mode"] = "fleet"
        plan.metrics["serve_plans"] = ",".join(h.plan_id
                                               for h in fleet.levels)
        # engine-local rids repeat across the fleet; key on trace order
        self.last_serve_results = dict(enumerate(results))
        self.last_fleet_report = rep
        if verbose:
            routed = {pid: p["requests"] for pid, p in rep["plans"].items()}
            print(f"[pipeline] fleet: {rep['requests']} requests over "
                  f"{rep['plans_resident']} plans {routed}, "
                  f"{rep['new_tokens']} tokens "
                  f"({rep['tokens_per_s']:.1f} tok/s), "
                  f"{rep['recompiles_after_warmup']} recompiles after "
                  f"warmup")


# ==================================================== routing-aware targets


# per-(layer, expert) slice names of `lm_compress.iter_eligible_units`:
# "blocks/g0/moe/w_gate[1][e2]", "tail/t0/moe/w_up[e0]",
# "blocks/g0/ssm/in_proj[1]", "tail/t0/mlp/w_down"
_EXPERT_SLICE_RE = re.compile(
    r"^(?P<base>.+)/(?P<key>[^/\[]+)(?:\[(?P<li>\d+)\])?\[e(?P<ei>\d+)\]$")
_LAYER_SLICE_RE = re.compile(
    r"^(?P<base>.+)/(?P<key>[^/\[]+)(?:\[(?P<li>\d+)\])?$")


def _slice_key(name: str) -> Tuple[str, int, Optional[int]]:
    """(unit path, layer index, expert index|None) of one energy-slice
    name."""
    m = _EXPERT_SLICE_RE.match(name)
    if m:
        return (f"{m.group('base')}/{m.group('key')}",
                int(m.group("li") or 0), int(m.group("ei")))
    m = _LAYER_SLICE_RE.match(name)
    if m:
        return (f"{m.group('base')}/{m.group('key')}",
                int(m.group("li") or 0), None)
    return (name, 0, None)


def traffic_weighted_unit_energies(energies: Dict[str, float],
                                   stats: rs.RoutingStats) -> Dict[str, float]:
    """Scale per-slice tile energies by measured routing traffic: expert
    slices are charged ``energy * share * E`` (uniform traffic changes
    nothing), scan-layer slices likewise against the activity share;
    slices without routing statistics pass through."""
    moe = {u: rs.traffic_shares(c) for u, c in stats.moe_counts.items()}
    scan = {u: rs.activity_shares(a) for u, a in stats.scan_activity.items()}
    out: Dict[str, float] = {}
    for name, e in energies.items():
        path, li, ei = _slice_key(name)
        base = path.rsplit("/", 1)[0]
        if ei is not None and base in moe:
            shares = moe[base]
            out[name] = float(e * shares[li, ei] * shares.shape[-1])
        elif ei is None and base in scan:
            shares = scan[base]
            out[name] = float(e * shares[li] * shares.size)
        else:
            out[name] = float(e)
    return out


class _RoutedTarget(LMTarget):
    """LM target with traffic-weighted per-unit compression (port of
    `repro.pipeline.targets._RoutedTarget`).

    The profile stage runs a calibration pass
    (`routing_stats.collect_lm_routing_stats`, batches from
    ``np.random.default_rng``) and stores it in ``plan.stats["routing"]``
    (the JAX package's keys, so plans cross both ways); the energy model
    scales each unit's tile energy by its measured share; the schedule
    gives every unit the uniform ``compress_k`` floor, then each routed
    slice a k from ``routing.k_ladder`` by traffic rank (hot units gentler,
    cold ones aggressive). Subclasses say which units are routed."""

    def _collect_routing(self, plan: CompressionPlan, cfg: PipelineConfig,
                         verbose: bool = False) -> rs.RoutingStats:
        self._on_device(plan)
        r = cfg.routing
        stats = rs.collect_lm_routing_stats(
            self.model, plan.params, comp=plan.comp,
            batches=r.calib_batches, batch_size=r.calib_batch_size,
            seq_len=r.calib_seq_len, seed=r.calib_seed)
        if plan.stats is None:
            plan.stats = {}
        plan.stats["routing"] = stats.as_arrays()
        self._routing_cache = stats
        if verbose:
            units = len(stats.moe_counts) + len(stats.scan_activity)
            print(f"[pipeline] routing calibration: {stats.tokens} tokens "
                  f"over {units} routed units")
        return stats

    def _routing_stats(self, plan: CompressionPlan,
                       cfg: PipelineConfig) -> rs.RoutingStats:
        """Cached -> plan-recorded -> freshly collected, in that order."""
        stats = getattr(self, "_routing_cache", None)
        if stats is not None:
            return stats
        arrays = (plan.stats or {}).get("routing")
        if arrays:
            self._routing_cache = rs.RoutingStats.from_arrays(dict(arrays))
            return self._routing_cache
        return self._collect_routing(plan, cfg)

    def _unit_energies(self, params, comp) -> Dict[str, float]:
        energies = super()._unit_energies(params, comp)
        stats = getattr(self, "_routing_cache", None)
        if stats is None:
            return energies
        return traffic_weighted_unit_energies(energies, stats)

    def _routed_assignments(self, stats: rs.RoutingStats,
                            cfg: PipelineConfig) -> List[Tuple]:
        """(path, layer, expert|None, k, traffic_share) per routed slice."""
        raise NotImplementedError

    # ------------------------------------------------------------- stages

    def stage_profile(self, plan: CompressionPlan, cfg: PipelineConfig,
                      verbose: bool = False) -> None:
        super().stage_profile(plan, cfg, verbose)
        self._collect_routing(plan, cfg, verbose)

    def stage_energy_model(self, plan: CompressionPlan, cfg: PipelineConfig,
                           verbose: bool = False) -> None:
        self._on_device(plan)
        self._routing_stats(plan, cfg)   # the traffic prior is live
        super().stage_energy_model(plan, cfg, verbose)

    def stage_schedule(self, plan: CompressionPlan, cfg: PipelineConfig,
                       verbose: bool = False) -> None:
        self._on_device(plan)
        k = cfg.serve.compress_k
        e_before = self._unit_energy_cache
        if e_before is None:
            e_before = self._unit_energies(plan.params, plan.comp)
        total_before = sum(e_before.values())
        plan.metrics["energy_before"] = float(total_before)
        if not k:
            plan.metrics["energy_after"] = float(total_before)
            return

        # the uniform floor first (every eligible unit gets the serve
        # codebook), then the traffic-ranked per-unit overrides
        plan.comp = lm_compress.restrict_all_codebooks(
            self.model, plan.comp, lm_compress.symmetric_codebook_values(k))
        stats = self._routing_stats(plan, cfg)
        routed = self._routed_assignments(stats, cfg)
        for path, li, ei, kk, _share in routed:
            plan.comp = lm_compress.set_codebook(
                plan.comp, path, lm_compress.symmetric_codebook_values(
                    int(kk)), layer=li, expert=ei)
        e_after = self._unit_energies(plan.params, plan.comp)

        assign = {(p, li, ei): (kk, share)
                  for p, li, ei, kk, share in routed}
        plan.decisions = []
        for name in e_before:
            kk, tshare = assign.get(_slice_key(name), (k, None))
            d = {"layer": name,
                 "share": e_before[name] / max(total_before, 1e-12),
                 "prune_ratio": None, "k": int(kk),
                 "energy_before": e_before[name],
                 "energy_after": e_after[name],
                 "accuracy": None, "accepted": True,
                 "tried": [[0.0, int(kk)]]}
            if tshare is not None:
                d["traffic_share"] = float(tshare)
            plan.decisions.append(d)

        plan.metrics["energy_after"] = float(sum(e_after.values()))
        plan.metrics["compress_k"] = k
        plan.metrics["routed_units"] = len(routed)
        plan.metrics["routing_tokens"] = int(stats.tokens)
        if verbose:
            ks = sorted({int(kk) for _, _, _, kk, _ in routed})
            print(f"[pipeline] routed {len(routed)} unit slices onto "
                  f"k ladder {ks} (uniform floor k={k}; per-token energy "
                  f"{total_before:.3g} -> "
                  f"{plan.metrics['energy_after']:.3g} eu)")


class MoETarget(_RoutedTarget):
    """MoE LM: per-expert codebooks sized by measured dispatch frequency,
    each expert's k by its rank within its layer."""

    kind = "moe"

    def _routed_assignments(self, stats: rs.RoutingStats,
                            cfg: PipelineConfig) -> List[Tuple]:
        ladder = tuple(cfg.routing.k_ladder)
        out: List[Tuple] = []
        for base, counts in sorted(stats.moe_counts.items()):
            shares = rs.traffic_shares(counts)
            for li in range(shares.shape[0]):
                ks = rs.assign_rank_k(shares[li], ladder)
                for key in lm_compress.MOE_EXPERT_KEYS:
                    for ei in range(shares.shape[1]):
                        out.append((f"{base}/{key}", li, ei, int(ks[ei]),
                                    float(shares[li, ei])))
        return out


class ScanTarget(_RoutedTarget):
    """SSM / RG-LRU LM: per-scan-unit codebooks sized by measured activity,
    each layer's k by its rank within its stack."""

    kind = "scan"

    def _routed_assignments(self, stats: rs.RoutingStats,
                            cfg: PipelineConfig) -> List[Tuple]:
        ladder = tuple(cfg.routing.k_ladder)
        by_base: Dict[str, List[str]] = {}
        for path in lm_compress.lm_comp_layers(self.model):
            by_base.setdefault(path.rsplit("/", 1)[0], []).append(path)
        out: List[Tuple] = []
        for base, act in sorted(stats.scan_activity.items()):
            shares = rs.activity_shares(act)
            ks = rs.assign_rank_k(shares, ladder)
            for li in range(shares.size):
                for path in by_base.get(base, ()):
                    out.append((path, li, None, int(ks[li]),
                                float(shares[li])))
        return out
