"""Staged pipeline driver (port of `repro.pipeline.pipeline`).

`Pipeline` drives a target through the stage registry

    profile -> energy_model -> schedule -> export -> serve

with every stage reading and writing the shared `CompressionPlan`. A saved
plan records which stages already ran; ``Pipeline.from_plan(plan)`` rebuilds
the target from the plan's embedded config and continues from the first
incomplete stage. Typical use::

    Pipeline(cfg).run()                     # all five stages on the card
    plan = CompressionPlan.load("plan")     # either package's plan
    Pipeline.from_plan(plan, device="cpu").run()
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.pipeline.config import PipelineConfig
from repro_torch.pipeline.plan import CompressionPlan
from repro_torch.pipeline.schema import STAGES, stage_index
from repro_torch.pipeline.targets import resolve_target


class Pipeline:
    """Stage driver bound to one target, one validated config and one
    device (``"cuda"`` unless the caller asks for ``"cpu"``)."""

    STAGES = STAGES

    def __init__(self, cfg: PipelineConfig, *,
                 plan: Optional[CompressionPlan] = None,
                 device=DEFAULT_DEVICE):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.target = resolve_target(cfg, self.device)
        if plan is None:
            plan = CompressionPlan(
                config=cfg.to_dict(),
                target={"kind": self.target.kind, "arch": cfg.target.arch,
                        "name": getattr(self.target, "name",
                                        cfg.target.arch)},
            )
        self.plan = plan

    # ----------------------------------------------------------------- runs

    def run(self, *, verbose: bool = False,
            overrides: Optional[Dict[str, Dict[str, Any]]] = None
            ) -> CompressionPlan:
        return self.run_until(STAGES[-1], verbose=verbose,
                              overrides=overrides)

    def run_until(self, stage: str, *, verbose: bool = False,
                  overrides: Optional[Dict[str, Dict[str, Any]]] = None
                  ) -> CompressionPlan:
        """Run every not-yet-completed stage up to and including ``stage``.
        The plan's embedded config is kept in sync with the effective config
        (base + overrides)."""
        cfg = self.cfg.with_overrides(overrides)
        self.plan.config = cfg.to_dict()
        last = stage_index(stage)
        to_run = [name for name in STAGES[: last + 1]
                  if not self.plan.is_done(name)]
        for name in to_run:
            t0 = time.time()
            getattr(self.target, f"stage_{name}")(self.plan, cfg,
                                                  verbose=verbose)
            self.plan.mark_done(name)
            self.plan.metrics[f"wall_s_{name}"] = round(time.time() - t0, 3)
            if verbose:
                print(f"[pipeline] stage {name} done "
                      f"({self.plan.metrics[f'wall_s_{name}']:.1f}s)")
        return self.plan

    # --------------------------------------------------------------- resume

    @classmethod
    def from_plan(cls, plan: CompressionPlan, *,
                  cfg: Optional[PipelineConfig] = None,
                  device=DEFAULT_DEVICE) -> "Pipeline":
        """Rebuild a pipeline around a saved plan; subsequent ``run*`` calls
        skip every stage the plan already completed."""
        if cfg is None:
            cfg = PipelineConfig.from_dict(plan.config)
        return cls(cfg, plan=plan, device=device)
