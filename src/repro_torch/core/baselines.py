"""Baselines the paper compares against (port of `repro.core.baselines`).

* ``powerpruning_global``: PowerPruning-style [15]. A *global* MAC energy
  model (the layers' LUTs averaged, weighted by each layer's weight count)
  drives one network-wide restricted weight set (default size 32) applied
  to every layer, plus one pruning ratio for all. No layer-wise
  scheduling, no greedy co-optimization.
* ``naive_topk``: the k lowest-energy weight values globally (paper 5.3.3,
  Table 4), which shows the accuracy collapse at k = 16.
* ``global_strategy``: Table 3's "Global" arm. The co-optimized selection
  runs once on network-aggregated statistics, and the same (prune, K) is
  applied to every layer.

Each takes the `CnnRunner` state ``(params, state, opt_state, comp,
stats)`` and returns ``(params, state, opt_state, comp, BaselineResult)``.
Fine-tuning is `CnnRunner.train` (QAT through the one grouped K3 launch a
forward), the energies are the runner's `LayerEnergyModel`s on the
profiled LUTs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core import qat
from repro_torch.core.layer_energy import LayerEnergyModel, MatmulDims
from repro_torch.core.weight_selection import (
    greedy_backward_elimination,
    initial_candidate_set,
    naive_lowest_energy_set,
)
from repro_torch.pipeline.config import SelectionConfig


@dataclasses.dataclass
class BaselineResult:
    name: str
    codebook: List[int]
    prune_ratio: float
    acc_before: float
    acc_after: float
    energy_before: float
    energy_after: float

    @property
    def energy_saving(self) -> float:
        return 1.0 - self.energy_after / max(self.energy_before, 1e-12)


def _global_lut_counts(models: Dict[str, LayerEnergyModel]):
    """(global LUT, summed counts) over the layers: each layer's LUT
    weighted by its weight count (the 'global activation model'
    simplification of prior work). Summed in float64, each rounded to
    float32 once."""
    luts = torch.stack([m.lut for m in models.values()]).double()
    counts = torch.stack([m.counts for m in models.values()]).double()
    weights = counts.sum(dim=1, keepdim=True)
    lut = (luts * weights).sum(0) / torch.clamp(weights.sum(0), min=1.0)
    return lut.float(), counts.sum(0).float()


def _apply_global_codebook(comp, values):
    """Every layer restricted to ``values``."""
    new_comp = {}
    for name, c in comp.items():
        cb, k = qat.make_codebook(values, device=c["codebook"].device)
        new_comp[name] = {**c, "codebook": cb, "codebook_k": k}
    return new_comp


def _apply_uniform_prune(runner, params, comp, ratio: float):
    """Every layer's mask: magnitude pruning at ``ratio``."""
    new_comp = {}
    for cl in runner.model.comp_layers:
        w = runner.model.get_weight(params, cl.name)
        new_comp[cl.name] = {**comp[cl.name],
                             "mask": qat.magnitude_prune_mask(w, ratio)}
    return new_comp


def _total_energy(runner, params, comp, models) -> float:
    refreshed = runner.refresh_counts(params, comp, models)
    return float(sum(m.energy for m in refreshed.values()))


def powerpruning_global(runner, params, state, opt_state, comp, stats, *,
                        k: int = 32, prune_ratio: float = 0.5,
                        finetune_steps: int = 100, eval_batches: int = 4
                        ) -> tuple:
    """PowerPruning-style global selection: the top ``k`` values of the
    global joint energy/usage ranking (no greedy co-optimization) and
    uniform magnitude pruning, then ``finetune_steps`` of QAT."""
    models = runner.energy_models(params, comp, stats)
    acc0 = runner.accuracy(params, state, comp, n_batches=eval_batches)
    e0 = float(sum(m.energy for m in models.values()))

    lut, counts = _global_lut_counts(models)
    values = initial_candidate_set(counts, lut,
                                   SelectionConfig(k_init=k, k_target=k))
    comp = _apply_uniform_prune(runner, params, comp, prune_ratio)
    comp = _apply_global_codebook(comp, values)
    params, state, opt_state, _ = runner.train(params, state, opt_state,
                                               comp, finetune_steps)
    acc1 = runner.accuracy(params, state, comp, n_batches=eval_batches)
    e1 = _total_energy(runner, params, comp, models)
    res = BaselineResult("powerpruning[15]", values, prune_ratio, acc0, acc1,
                         e0, e1)
    return params, state, opt_state, comp, res


def naive_topk(runner, params, state, opt_state, comp, stats, *,
               k: int = 16, finetune_steps: int = 100,
               eval_batches: int = 4) -> tuple:
    """Naive lowest-energy top-k selection (Table 4)."""
    models = runner.energy_models(params, comp, stats)
    acc0 = runner.accuracy(params, state, comp, n_batches=eval_batches)
    e0 = float(sum(m.energy for m in models.values()))

    lut, _ = _global_lut_counts(models)
    values = naive_lowest_energy_set(lut, k)
    comp = _apply_global_codebook(comp, values)
    params, state, opt_state, _ = runner.train(params, state, opt_state,
                                               comp, finetune_steps)
    acc1 = runner.accuracy(params, state, comp, n_batches=eval_batches)
    e1 = _total_energy(runner, params, comp, models)
    res = BaselineResult(f"naive-top{k}", values, 0.0, acc0, acc1, e0, e1)
    return params, state, opt_state, comp, res


def global_strategy(runner, params, state, opt_state, comp, stats, *,
                    prune_ratio: float = 0.5, k_target: int = 16,
                    acc0: Optional[float] = None, finetune_steps: int = 100,
                    eval_batches: int = 4,
                    sel_cfg: Optional[SelectionConfig] = None) -> tuple:
    """Table 3's 'Global' arm: co-optimized selection on aggregated
    statistics, one (prune, K) for every layer. Uniform pruning and half
    the fine-tune, then one greedy elimination on a pseudo layer whose
    counts are the network's, each trial codebook applied to all layers,
    then the full fine-tune."""
    models = runner.energy_models(params, comp, stats)
    if acc0 is None:
        acc0 = runner.accuracy(params, state, comp, n_batches=eval_batches)
    e0 = float(sum(m.energy for m in models.values()))
    sel_cfg = dataclasses.replace(sel_cfg or SelectionConfig(),
                                  k_target=k_target)

    comp = _apply_uniform_prune(runner, params, comp, prune_ratio)
    params, state, opt_state, _ = runner.train(params, state, opt_state,
                                               comp,
                                               max(finetune_steps // 2, 1))
    lut, counts = _global_lut_counts(runner.refresh_counts(params, comp,
                                                           models))
    init_set = initial_candidate_set(counts, lut, sel_cfg)
    total_n = sum(m.dims.n for m in models.values())
    pseudo = LayerEnergyModel("global", MatmulDims(64, 64, max(total_n, 64)),
                              lut, counts)

    def eval_with_codebook(values, n_batches):
        return runner.accuracy(params, state,
                               _apply_global_codebook(comp, values),
                               n_batches=n_batches)

    values, _ = greedy_backward_elimination(
        pseudo, init_set, sel_cfg, acc0,
        eval_with_codebook=eval_with_codebook)
    comp = _apply_global_codebook(comp, values)
    params, state, opt_state, _ = runner.train(params, state, opt_state,
                                               comp, finetune_steps)
    acc1 = runner.accuracy(params, state, comp, n_batches=eval_batches)
    e1 = _total_energy(runner, params, comp, models)
    res = BaselineResult(f"global-p{prune_ratio}-k{k_target}", values,
                         prune_ratio, acc0, acc1, e0, e1)
    return params, state, opt_state, comp, res
