"""Pipeline targets (port of `repro.pipeline.targets`).

A target owns the model runtime and implements one method per pipeline
stage; each takes the shared `CompressionPlan` and the `PipelineConfig` and
mutates only the plan. The CNN target's five stages are ported operation for
operation: ``profile`` (QAT base training, then the trace statistics),
``energy_model``, ``schedule`` (both search modes, the batched candidate
sweep by default), ``export`` and ``serve``. What is not ported (the cosim
gate, the LM-family targets) raises `NotImplementedError` naming the
ROADMAP.md item that ports it, from `CnnTarget.check_ported` or
`resolve_target` before any stage runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import tree_to
from repro_torch.core.export import export_model, export_summary
from repro_torch.core.runner import CnnRunner
from repro_torch.core.schedule import energy_prioritized_compression
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.nn.cnn import CNN_FACTORIES
from repro_torch.nn.layers import QuantConfig
from repro_torch.pipeline.config import PipelineConfig
from repro_torch.pipeline.plan import CompressionPlan, decision_dict

_NOT_PORTED = {
    "verify_cosim": "ROADMAP.md Queue 1 item 9, 'Bit-accurate cosim'",
    "lm": "ROADMAP.md Queue 1, 'LM stack' and 'Serving'",
    "moe": "ROADMAP.md Queue 1, 'Routed targets'",
    "scan": "ROADMAP.md Queue 1, 'Routed targets'",
}


def resolve_target(cfg: PipelineConfig, device: torch.device):
    if cfg.target.kind == "cnn":
        return CnnTarget(cfg, device)
    if cfg.target.kind in _NOT_PORTED:
        raise NotImplementedError(
            f"target kind {cfg.target.kind!r} is not ported yet: "
            f"{_NOT_PORTED[cfg.target.kind]}")
    raise ValueError(f"unknown target kind {cfg.target.kind!r}")


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

    @staticmethod
    def check_ported(cfg: PipelineConfig, stages) -> None:
        """Raise `NotImplementedError`, naming its ROADMAP.md item, for any
        option of the ``stages`` about to run that the port does not have
        yet. `Pipeline` calls this before the first of them does work."""
        if "profile" in stages and cfg.profile.verify_cosim:
            raise NotImplementedError(
                "profile with verify_cosim=True is not ported yet: "
                f"{_NOT_PORTED['verify_cosim']}")

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
        per compressible layer on the card)."""
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
