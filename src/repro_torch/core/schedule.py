"""Energy-prioritized layer-wise compression schedule (port of
`repro.core.schedule`, paper 4.3).

Layers are sorted by normalized energy share rho_l = E_l / sum_j E_j and
processed in descending order. For each layer the schedule tries candidate
configurations (prune ratio x target codebook size x MSR truncation depth),
most aggressive first, and accepts the first whose post-finetune *global*
validation accuracy stays above ``acc0 - delta``. Low-energy layers
therefore receive milder compression.

Two search modes make the same decisions, as in the JAX package:

* ``search_mode="serial"``: the reference trial-and-rollback walk, one
  candidate at a time, each paying its own trial fine-tune, greedy weight
  selection and eval before rolling back on reject.
* ``search_mode="batched"`` (the default): all (prune, k, msr) candidates
  of a layer advance in lockstep. Their comp states are stacked along a
  leading candidate axis (`qat.stack_pytrees`; the layers not under
  search are one shared stride-0 view, `qat.broadcast_pytree`), and each
  trial fine-tune step and evaluation batch runs every candidate in one
  forward (`CnnRunner.train_batched` / `accuracy_batched`: one grouped K3
  launch, one grouped convolution a layer). The greedy eliminations of all
  candidates advance together (`lockstep_backward_elimination`), each
  round's trial codebooks across candidates fused into one gathered
  evaluation (`CnnRunner.accuracy_gather`). The first candidate in
  `_candidate_order` whose accuracy passes is the one the serial walk
  accepts. An optional 1-D device mesh (`CnnRunner.sweep_mesh`,
  `repro_torch.distributed.sharding.sweep_mesh`) splits the candidate axis
  of the fine-tune and accept stages over its shards, as the JAX package's
  ``shard_map`` does; the decisions, masks, codebooks and params are the
  unsharded sweep's bit for bit.

`ScheduleConfig` is the one in `repro_torch.pipeline.config`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import qat
from repro_torch.core.lm_compress import symmetric_codebook_values
from repro_torch.core.layer_energy import (
    layer_energy_from_counts,
    weight_value_counts,
)
from repro_torch.core.stats import conv_weight_matrix
from repro_torch._device import tree_map
from repro_torch.core.weight_selection import (
    SelectionReport,
    codebook_comp,
    greedy_backward_elimination,
    initial_candidate_set,
    lockstep_backward_elimination,
)
from repro_torch.pipeline.config import ScheduleConfig, SelectionConfig

# upper bound on the gathered param/comp copies one lockstep evaluation may
# hold at once (a memory guard; requests beyond it are chunked)
_MAX_EVAL_FANOUT = 64


@dataclasses.dataclass
class LayerDecision:
    layer: str
    share: float
    prune_ratio: Optional[float]
    k: Optional[int]
    energy_before: float
    energy_after: float
    accuracy: float
    accepted: bool
    tried: List[Tuple[float, int, int]] = dataclasses.field(
        default_factory=list)
    msr: Optional[int] = None   # accepted MSR depth (0/None = off)

    @property
    def saving(self) -> float:
        if self.energy_before <= 0:
            return 0.0
        return 1.0 - self.energy_after / self.energy_before


@dataclasses.dataclass
class ScheduleResult:
    decisions: List[LayerDecision]
    acc0: float
    acc_final: float
    energy_before: float
    energy_after: float
    selection_reports: List[SelectionReport]

    @property
    def energy_saving(self) -> float:
        return 1.0 - self.energy_after / max(self.energy_before, 1e-12)


def _config_order(cfg: ScheduleConfig) -> List[Tuple[float, int, int]]:
    """All (prune, k, msr) combos, most aggressive (highest expected saving)
    first: higher prune, then MSR truncation on before off (fewer kept bits
    = more aggressive), then smaller k."""
    combos = [(p, k, m) for p in cfg.prune_ratios for k in cfg.k_targets
              for m in cfg.msr_bits]
    return sorted(combos, key=lambda c: (-c[0], c[2] == 0, c[2], c[1]))


def _candidate_order(runner, params, comp, models, layer,
                     cfg: ScheduleConfig) -> List[Tuple[float, int, int]]:
    """Candidate combos for one layer, most aggressive first.

    With ``msr_energy_prior`` off, or no non-zero MSR depth in play, this is
    exactly `_config_order`. Otherwise each combo's post-compression layer
    energy is *estimated* (prune mask + symmetric k-value codebook proxy +
    MSR truncation -> int weight histogram -> LUT energy) and the combos are
    reordered by that estimate ascending, ties broken by the static order.
    """
    combos = _config_order(cfg)
    if not cfg.msr_energy_prior or all(m == 0 for m in cfg.msr_bits):
        return combos

    cl = runner.model.comp_layer(layer)
    m = models[layer]
    w = runner.model.get_weight(params, layer)
    cost = []
    for prune, k_target, msr in combos:
        cb, k = qat.make_codebook(symmetric_codebook_values(k_target),
                                  device=w.device)
        c_est = dict(comp[layer])
        c_est["mask"] = qat.magnitude_prune_mask(w, prune)
        c_est["codebook"] = cb
        c_est["codebook_k"] = k
        c_est["msr_bits"] = torch.tensor(msr, dtype=torch.int32,
                                         device=w.device)
        w_int = qat.quantize_weight_int(w, c_est)
        w_int = conv_weight_matrix(w_int) if cl.kind == "conv" else w_int.T
        counts = weight_value_counts(w_int, m.dims)
        cost.append(float(layer_energy_from_counts(counts, m.lut, m.dims)))
    order = sorted(range(len(combos)), key=lambda i: (cost[i], i))
    return [combos[i] for i in order]


def _sweep_layer_serial(runner, params, state, opt_state, comp, models,
                        layer, share, acc0, cfg, sel_cfg, verbose):
    """Reference trial-and-rollback walk: one candidate config at a time."""
    e_before = models[layer].energy
    tried: List[Tuple[float, int, int]] = []
    for prune, k_target, msr in _candidate_order(runner, params, comp,
                                                 models, layer, cfg):
        tried.append((prune, k_target, msr))
        t0 = time.time()
        # --- trial state (rollback on reject)
        t_params, t_state, t_opt = params, state, opt_state
        t_comp = {n: dict(c) for n, c in comp.items()}

        # 1. prune + MSR truncation depth for this candidate
        w = runner.model.get_weight(t_params, layer)
        t_comp[layer]["mask"] = qat.magnitude_prune_mask(w, prune)
        t_comp[layer]["msr_bits"] = torch.tensor(msr, dtype=torch.int32,
                                                 device=w.device)

        # 2. fine-tune with the mask (paper: pruning first, then finetune)
        if cfg.trial_finetune_steps:
            t_params, t_state, t_opt, _ = runner.train(
                t_params, t_state, t_opt, t_comp, cfg.trial_finetune_steps)

        # 3. weight-set selection on the pruned layer
        t_models = runner.refresh_counts(t_params, t_comp, models)
        lsel = dataclasses.replace(sel_cfg, k_target=k_target)
        init_set = initial_candidate_set(
            t_models[layer].counts, t_models[layer].lut, lsel)

        def eval_with_codebook(values, n_batches, _layer=layer,
                               _params=t_params, _state=t_state,
                               _comp=t_comp):
            c2 = codebook_comp(_comp, _layer, values)
            return runner.accuracy(_params, _state, c2, n_batches=n_batches)

        final_set, rep = greedy_backward_elimination(
            t_models[layer], init_set, lsel, acc0,
            eval_with_codebook=eval_with_codebook)
        t_comp = codebook_comp(t_comp, layer, final_set)

        # 4. short fine-tune with the restriction active, then accept check
        if cfg.finetune_steps:
            t_params, t_state, t_opt, _ = runner.train(
                t_params, t_state, t_opt, t_comp, cfg.finetune_steps)
        acc = runner.accuracy(t_params, t_state, t_comp,
                              n_batches=cfg.eval_batches)
        if verbose:
            print(f"  try prune={prune} k={k_target} msr={msr}: "
                  f"acc={acc:.3f} (floor {acc0 - cfg.delta_acc:.3f}) "
                  f"[{time.time() - t0:.1f}s]")
        if acc >= acc0 - cfg.delta_acc:
            models = runner.refresh_counts(t_params, t_comp, models)
            decision = LayerDecision(
                layer, share, prune, k_target, e_before,
                models[layer].energy, acc, True, tried, msr=msr)
            return t_params, t_state, t_opt, t_comp, models, decision, rep

    decision = LayerDecision(layer, share, None, None, e_before, e_before,
                             acc0, False, tried)
    return params, state, opt_state, comp, models, decision, None


def _stack_comps(cand_comps, comp, layer):
    """The candidates' comp trees with a leading candidate axis: ``layer``'s
    leaves stacked (one mask, codebook and depth a candidate), every other
    layer's the caller's one state, shared (stride 0: not copied, and read
    once by the grouped fake-quant launch)."""
    n = len(cand_comps)
    return {nm: (qat.stack_pytrees([c[layer] for c in cand_comps])
                 if nm == layer else qat.broadcast_pytree(cc, n))
            for nm, cc in comp.items()}


def _sweep_layer_batched(runner, params, state, opt_state, comp, models,
                         layer, share, acc0, cfg, sel_cfg, verbose):
    """Batched candidate sweep: every (prune, k, msr) trial advances in
    lockstep. The n candidates are independent given their comp states, so
    the serial walk's rollback is free here: a rejected candidate is never
    taken out of the stacked trees, and the caller's params, state,
    opt_state and comp objects come back untouched when no candidate
    passes."""
    combos = _candidate_order(runner, params, comp, models, layer, cfg)
    n = len(combos)
    e_before = models[layer].energy
    t0 = time.time()
    w = runner.model.get_weight(params, layer)

    # 1. prune: per-candidate comp trees (identical except this layer's
    # mask and MSR truncation depth)
    cand_comps = []
    for prune, _k, msr in combos:
        c = {nm: dict(cc) for nm, cc in comp.items()}
        c[layer]["mask"] = qat.magnitude_prune_mask(w, prune)
        c[layer]["msr_bits"] = torch.tensor(msr, dtype=torch.int32,
                                            device=w.device)
        cand_comps.append(c)
    comps_s = _stack_comps(cand_comps, comp, layer)
    params_s = qat.broadcast_pytree(params, n)
    state_s = qat.broadcast_pytree(state, n)
    opt_s = qat.broadcast_pytree(opt_state, n)

    # 2. trial fine-tune, all candidates a step in one forward and backward;
    # each candidate sees the batch stream the serial walk feeds it
    if cfg.trial_finetune_steps:
        params_s, state_s, opt_s, _ = runner.train_batched(
            params_s, state_s, opt_s, comps_s, cfg.trial_finetune_steps)

    # 3. weight-set selection: the candidates' greedy eliminations advance
    # in lockstep; each sync point fuses the outstanding codebook evals of
    # all candidates into one gathered evaluation, every trial scored
    # against its own candidate's fine-tuned weights. The dE refresh
    # touches only the layer under search.
    lsels = [dataclasses.replace(sel_cfg, k_target=k) for _, k, _ in combos]
    t_models, init_sets = [], []
    for i in range(n):
        m_i = runner.refresh_layer_counts(
            tree_map(lambda x, i=i: x[i], params_s), cand_comps[i], models,
            layer)
        t_models.append(m_i)
        init_sets.append(initial_candidate_set(m_i.counts, m_i.lut,
                                               lsels[i]))

    masks_s = comps_s[layer]["mask"]
    msrs_s = comps_s[layer]["msr_bits"]
    # requests are padded to multiples of n (a few distinct evaluation
    # widths a sweep) and chunked to at most _MAX_EVAL_FANOUT gathered
    # copies; the shared non-target comps are cached per width
    rest_cache: Dict[int, Dict[str, qat.CompState]] = {}
    max_chunk = max(n, (_MAX_EVAL_FANOUT // n) * n)

    def eval_chunk(reqs, n_batches):
        n_req = len(reqs)
        cap = -(-n_req // n) * n
        padded = list(reqs) + [reqs[-1]] * (cap - n_req)
        idx = torch.tensor([i for i, _ in padded], device=w.device)
        cbs, ks = qat.make_codebooks([v for _, v in padded], device=w.device)
        if cap not in rest_cache:
            rest_cache[cap] = {nm: qat.broadcast_pytree(cc, cap)
                               for nm, cc in comp.items() if nm != layer}
        comps_e = dict(rest_cache[cap])
        comps_e[layer] = {
            "mask": masks_s.index_select(0, idx),
            "codebook": cbs,
            "codebook_k": ks,
            # each request scores against its own candidate's MSR depth,
            # as in the serial walk
            "msr_bits": msrs_s.index_select(0, idx),
        }
        return list(runner.accuracy_gather(params_s, state_s, comps_e, idx,
                                           n_batches=n_batches)[:n_req])

    def eval_requests(reqs, n_batches):
        out = []
        for lo in range(0, len(reqs), max_chunk):
            out.extend(eval_chunk(reqs[lo:lo + max_chunk], n_batches))
        return out

    sel_out = lockstep_backward_elimination(
        t_models, init_sets, lsels, acc0, eval_requests=eval_requests)
    sel_reports: List[SelectionReport] = [rep for _, rep in sel_out]
    for i, (final_set, _) in enumerate(sel_out):
        cand_comps[i] = codebook_comp(cand_comps[i], layer, final_set)
    comps_s = _stack_comps(cand_comps, comp, layer)

    # 4. short fine-tune with the restrictions active, then the accept
    # check: one batched evaluation gives every candidate's accuracy
    if cfg.finetune_steps:
        params_s, state_s, opt_s, _ = runner.train_batched(
            params_s, state_s, opt_s, comps_s, cfg.finetune_steps)
    accs = runner.accuracy_batched(params_s, state_s, comps_s,
                                   n_batches=cfg.eval_batches)

    floor = acc0 - cfg.delta_acc
    if verbose:
        for (prune, k_target, msr), acc in zip(combos, accs):
            print(f"  cand prune={prune} k={k_target} msr={msr}: "
                  f"acc={acc:.3f} (floor {floor:.3f})")
        print(f"  [batched sweep of {n} candidates: {time.time() - t0:.1f}s]")

    # accept the most aggressive passing candidate (combos run aggressive
    # -> mild, so this is the serial walk's first accept)
    passing = [i for i, acc in enumerate(accs) if acc >= floor]
    if not passing:
        decision = LayerDecision(layer, share, None, None, e_before, e_before,
                                 acc0, False, list(combos))
        return params, state, opt_state, comp, models, decision, None

    i = passing[0]
    prune, k_target, msr = combos[i]
    params = qat.index_pytree(params_s, i)
    state = qat.index_pytree(state_s, i)
    opt_state = qat.index_pytree(opt_s, i)
    comp = cand_comps[i]
    models = runner.refresh_counts(params, comp, models)
    decision = LayerDecision(layer, share, prune, k_target, e_before,
                             models[layer].energy, float(accs[i]), True,
                             list(combos[: i + 1]), msr=msr)
    return params, state, opt_state, comp, models, decision, sel_reports[i]


_SEARCH_MODES = {"serial": _sweep_layer_serial,
                 "batched": _sweep_layer_batched}


def energy_prioritized_compression(
    runner, params, state, opt_state, comp: Dict[str, qat.CompState], stats,
    cfg: ScheduleConfig, sel_cfg: Optional[SelectionConfig] = None, *,
    verbose: bool = False,
) -> Tuple[object, object, object, Dict[str, qat.CompState], ScheduleResult]:
    """Run the full layer-wise schedule. Returns updated (params, state,
    opt_state, comp, result).

    ``stats=None`` profiles through the runner (cached on the runner); every
    dE refresh below reuses those trace statistics, only the O(256)
    weight-value histograms are recomputed per trial."""
    sel_cfg = sel_cfg or SelectionConfig(delta_acc=cfg.delta_acc)
    try:
        sweep_layer = _SEARCH_MODES[cfg.search_mode]
    except KeyError:
        raise ValueError(
            f"search_mode must be one of {sorted(_SEARCH_MODES)}, "
            f"got {cfg.search_mode!r}") from None

    acc0 = runner.accuracy(params, state, comp, n_batches=cfg.eval_batches)
    if stats is None:
        stats = runner.layer_stats(params, state, comp)
    models = runner.energy_models(params, comp, stats)
    e_total_before = sum(m.energy for m in models.values())
    shares = {n: m.energy / max(e_total_before, 1e-12)
              for n, m in models.items()}
    order = sorted(shares, key=lambda n: -shares[n])
    if cfg.max_layers is not None:
        order = order[: cfg.max_layers]

    decisions: List[LayerDecision] = []
    reports: List[SelectionReport] = []

    for layer in order:
        share = shares[layer]
        e_before = models[layer].energy
        if share < cfg.min_energy_share:
            decisions.append(LayerDecision(layer, share, None, None, e_before,
                                           e_before, acc0, False))
            continue
        if verbose:
            print(f"[schedule] layer={layer} share={share:.3f} "
                  f"mode={cfg.search_mode}")

        params, state, opt_state, comp, models, decision, rep = sweep_layer(
            runner, params, state, opt_state, comp, models, layer, share,
            acc0, cfg, sel_cfg, verbose)
        decisions.append(decision)
        if rep is not None:
            reports.append(rep)

    models = runner.refresh_counts(params, comp, models)
    e_total_after = sum(m.energy for m in models.values())
    acc_final = runner.accuracy(params, state, comp,
                                n_batches=cfg.eval_batches)
    result = ScheduleResult(
        decisions=decisions, acc0=acc0, acc_final=acc_final,
        energy_before=e_total_before, energy_after=e_total_after,
        selection_reports=reports)
    return params, state, opt_state, comp, result
