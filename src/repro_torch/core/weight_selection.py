"""Energy-accuracy co-optimized weight-set selection (port of
`repro.core.weight_selection`, paper 4.2).

Two stages per layer:

1. **Safe initial candidate set** (4.2.1): rank all int8 weight values by a
   joint score favoring *low energy* and *high usage* in this layer, take the
   top ``k_init`` (default 32). Zero is force-included (pruned weights must
   stay representable).

2. **Greedy backward elimination** (4.2.2): repeatedly score every removable
   value ``w`` by ``S(w) = dE(w) / (dAcc(w) + eps)`` where dE remaps all
   occurrences of ``w`` to the nearest remaining value (O(256) via the
   histogram energy model, on the host) and dAcc is measured by a cheap
   calibration pass. The best-scoring removal is accepted iff the full
   validation accuracy stays above ``acc0 - delta``; otherwise the value is
   marked *essential* and skipped thereafter. Terminates at ``k_target`` or
   when nothing is removable.

The serial loop (`greedy_backward_elimination`) and the batched sweep's
lockstep loop (`lockstep_backward_elimination`) run the same generator,
so they make the same decisions. `SelectionConfig` is the one in
`repro_torch.pipeline.config`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import qat
from repro_torch.core.layer_energy import PASS_ENERGY_SCALE, LayerEnergyModel
from repro_torch.pipeline.config import SelectionConfig


@dataclasses.dataclass
class SelectionReport:
    layer: str
    initial: List[int]
    final: List[int]
    removed: List[int]
    essential: List[int]
    energy_before: float
    energy_after: float
    acc_checks: int = 0


def _host(t, dtype=np.float64) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype)


def initial_candidate_set(counts, lut, cfg: SelectionConfig) -> List[int]:
    """Joint low-energy / high-usage ranking (paper 4.2.1)."""
    counts = _host(counts)
    lut = _host(lut)
    e_min, e_max = lut.min(), lut.max()
    norm_e = (lut - e_min) / max(e_max - e_min, 1e-12)
    norm_u = counts / max(counts.max(), 1.0)
    score = cfg.usage_weight * norm_u - (1.0 - cfg.usage_weight) * norm_e
    order = np.argsort(-score)
    chosen = [int(i) - 128 for i in order[: cfg.k_init]]
    if 0 not in chosen:
        chosen[-1] = 0
    return sorted(chosen)


def nearest_other(values: Sequence[int], w: int) -> int:
    others = [v for v in values if v != w]
    return min(others, key=lambda v: (abs(v - w), v))


def _elimination_requests(model: LayerEnergyModel, candidate: List[int],
                          cfg: SelectionConfig, acc0: float):
    """Generator core of greedy backward elimination (paper 4.2.2).

    Yields ``(value_sets, n_batches)`` accuracy requests, a *list* of trial
    codebooks to measure, and expects ``send()`` to answer with the matching
    list of accuracies. Returns ``(final_values, SelectionReport)`` through
    ``StopIteration.value``. The JAX package's serial and lockstep drivers
    share this core, so their decisions are identical."""
    values = sorted(candidate)
    # host-side float64 mirrors of the O(256) energy model: the dE ranking
    # runs hundreds of times per layer and must not cost a device round trip
    # per candidate value
    counts = _host(model.counts).copy()
    lut = _host(model.lut)
    dims = model.dims
    scale = float(PASS_ENERGY_SCALE) * dims.n_tiles
    e_before = float(np.sum(counts * lut) * scale)
    essential: set = set()
    removed: List[int] = []
    acc_checks = 0

    (acc_ref,) = yield ([values], cfg.score_batches)
    acc_checks += 1

    while len(values) > cfg.k_target:
        removable = [w for w in values if w not in essential and w != 0]
        if not removable:
            break

        # cheap dE for every candidate; rank, then score dAcc for the top few
        d_es = {}
        for w in removable:
            nb = nearest_other(values, w)
            d_es[w] = float(counts[w + 128] * (lut[w + 128] - lut[nb + 128])
                            * scale)
        by_de = sorted(removable, key=lambda w: -d_es[w])
        to_score = by_de[: cfg.max_score_candidates]

        trials = [[v for v in values if v != w] for w in to_score]
        accs = yield (trials, cfg.score_batches)
        acc_checks += len(trials)
        scores = {}
        for w, acc_w in zip(to_score, accs):
            d_acc = max(acc_ref - float(acc_w), 0.0)
            scores[w] = d_es[w] / (d_acc + cfg.epsilon)

        w_star = max(scores, key=scores.get)
        trial = [v for v in values if v != w_star]
        (acc_new,) = yield ([trial], cfg.accept_batches)
        acc_checks += 1
        if acc_new >= acc0 - cfg.delta_acc:
            nb = nearest_other(values, w_star)
            counts[nb + 128] += counts[w_star + 128]
            counts[w_star + 128] = 0.0
            values = trial
            removed.append(w_star)
            (acc_ref,) = yield ([values], cfg.score_batches)
            acc_checks += 1
        else:
            essential.add(w_star)

    e_after = float(np.sum(counts * lut) * scale)
    report = SelectionReport(
        layer=model.name, initial=sorted(candidate), final=sorted(values),
        removed=removed, essential=sorted(essential), energy_before=e_before,
        energy_after=e_after, acc_checks=acc_checks)
    return sorted(values), report


def greedy_backward_elimination(
    model: LayerEnergyModel, candidate: List[int], cfg: SelectionConfig,
    acc0: float, *, eval_with_codebook,
) -> Tuple[List[int], SelectionReport]:
    """Paper 4.2.2, serial driver. ``eval_with_codebook(values, n_batches)
    -> float`` measures global val accuracy with this layer restricted to
    ``values`` (other layers unchanged)."""
    gen = _elimination_requests(model, candidate, cfg, acc0)
    answer = None
    try:
        while True:
            value_sets, n_batches = gen.send(answer) if answer is not None \
                else next(gen)
            answer = [eval_with_codebook(v, n_batches) for v in value_sets]
    except StopIteration as stop:
        return stop.value


def lockstep_backward_elimination(
    models: Sequence[LayerEnergyModel], candidates: Sequence[List[int]],
    cfgs: Sequence[SelectionConfig], acc0: float, *, eval_requests,
) -> List[Tuple[List[int], SelectionReport]]:
    """Advance N independent greedy eliminations in lockstep (the batched
    sweep's selection stage). Each is the `_elimination_requests` generator
    the serial loop runs, so its decisions are the serial ones; every sync
    point fuses the outstanding requests of all eliminations with the same
    ``n_batches`` (a round's trial codebooks across all candidates, then
    the accept checks, then the ``acc_ref`` refreshes) into one
    ``eval_requests([(cand_idx, values)], n_batches) -> accuracies`` call,
    which the schedule serves with one batched evaluation
    (`CnnRunner.accuracy_gather`)."""
    gens = [_elimination_requests(m, c, cfg, acc0)
            for m, c, cfg in zip(models, candidates, cfgs)]
    results: List[Optional[Tuple[List[int], SelectionReport]]] = \
        [None] * len(gens)
    pending = {i: next(g) for i, g in enumerate(gens)}  # first yield: always
    while pending:
        by_nb: Dict[int, List[int]] = {}
        for i, (_, n_batches) in pending.items():
            by_nb.setdefault(n_batches, []).append(i)
        next_pending = {}
        for n_batches, idxs in sorted(by_nb.items()):
            reqs = [(i, vals) for i in idxs for vals in pending[i][0]]
            accs = eval_requests(reqs, n_batches)
            pos = 0
            for i in idxs:
                take = len(pending[i][0])
                mine = [float(a) for a in accs[pos:pos + take]]
                pos += take
                try:
                    next_pending[i] = gens[i].send(mine)
                except StopIteration as stop:
                    results[i] = stop.value
        pending = next_pending
    return results


def naive_lowest_energy_set(lut, k: int) -> List[int]:
    """Baseline (paper 5.3.3): the k lowest-energy weight values, ignoring
    representational importance."""
    # argsort in the LUT's own dtype, as the JAX package does, so ties
    # break the same way
    order = np.argsort(_host(lut, None))
    return sorted(int(i) - 128 for i in order[:k])


def codebook_comp(comp: Dict[str, qat.CompState], layer: str,
                  values: Sequence[int]) -> Dict[str, qat.CompState]:
    """Functional update: new comp dict with ``layer`` restricted to
    ``values`` (tensors on the device of the layer's codebook)."""
    cb, k = qat.make_codebook(values, device=comp[layer]["codebook"].device)
    new_layer = dict(comp[layer])
    new_layer["codebook"], new_layer["codebook_k"] = cb, k
    out = dict(comp)
    out[layer] = new_layer
    return out


def msr_comp(comp: Dict[str, qat.CompState], layer: str,
             bits: int) -> Dict[str, qat.CompState]:
    """Functional update: set ``layer``'s MSR truncation depth (0 = off)."""
    new_layer = dict(comp[layer])
    new_layer["msr_bits"] = torch.tensor(
        int(bits), dtype=torch.int32, device=comp[layer]["codebook"].device)
    out = dict(comp)
    out[layer] = new_layer
    return out
