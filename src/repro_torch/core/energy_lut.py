"""Per-layer, per-weight-value MAC energy LUTs (port of
`repro.core.energy_lut`, paper 3.1).

Two routes to the 256-entry LUT ``E_l(w)``:

1. ``trace`` — exact average over the sampled systolic trace
   (`LayerStats.trace_lut`).
2. ``grouped`` — the paper's model: synthesize MAC input traces by sampling
   independently from the layer's activation transition histogram and its
   50x50 grouped partial-sum transition histogram, with per-group
   representative values, and average the MAC energy per weight value.

The Monte-Carlo draw is split from the evaluation: `grouped_lut_from_draws`
evaluates the LUT from given draws, and `grouped_model_lut` draws them from
a CPU `torch.Generator` (seed 1 by default, as the JAX package's key), so a
seed gives the same LUT on every device. The draws differ from
`jax.random`'s; tests hand both packages the same draws instead.
``uniform_trace_lut`` (the LM's per-token energy) draws its own Monte-Carlo
sample the same way (`uniform_lut_from_draws` evaluates given draws).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.grouping import N_GROUPS, group_representatives
from repro_torch.core.mac_model import (
    DEFAULT_COEFFS,
    MacEnergyCoeffs,
    mac_transition_energy,
)
from repro_torch.core.stats import N_WVALS, LayerStats

_REP_CACHE: Dict[Tuple[int, int], torch.Tensor] = {}


def _reps(samples_per_group: int = 8, seed: int = 17) -> torch.Tensor:
    key = (samples_per_group, seed)
    if key not in _REP_CACHE:
        _REP_CACHE[key] = group_representatives(
            torch.Generator().manual_seed(seed), samples_per_group)
    return _REP_CACHE[key]


def grouped_lut_from_draws(a_idx: torch.Tensor, g_idx: torch.Tensor,
                           r1: torch.Tensor, r2: torch.Tensor,
                           reps: torch.Tensor,
                           coeffs: MacEnergyCoeffs = DEFAULT_COEFFS
                           ) -> torch.Tensor:
    """The grouped LUT (256,) float32 from explicit Monte-Carlo draws.

    a_idx (n,) activation-pair bins ``(a_prev + 128) * 256 + a_cur + 128``;
    g_idx (n,) group-pair bins ``g_prev * 50 + g_cur``; r1, r2 (n,)
    representative columns for p_prev / p_cur; reps (50, R) int32."""
    a_prev = (a_idx // N_WVALS).to(torch.int32) - 128
    a_cur = (a_idx % N_WVALS).to(torch.int32) - 128
    g_prev = (g_idx // N_GROUPS).long()
    g_cur = (g_idx % N_GROUPS).long()
    p_prev = reps[g_prev, r1.long()]
    p_cur = reps[g_cur, r2.long()]
    w = torch.arange(-128, 128, dtype=torch.int32, device=a_idx.device)[:, None]
    e = mac_transition_energy(w, a_prev[None], a_cur[None], p_prev[None],
                              p_cur[None], coeffs)          # (256, n)
    return e.mean(dim=1)


def grouped_model_lut(stats: LayerStats, *, n_mc: int = 4096,
                      generator: Optional[torch.Generator] = None,
                      coeffs: MacEnergyCoeffs = DEFAULT_COEFFS,
                      samples_per_group: int = 8) -> torch.Tensor:
    """Paper's grouped statistical per-weight LUT, shape (256,) float32, on
    the device of ``stats``. Draws: activation and group pairs with
    probability proportional to ``hist + 1e-20`` (the JAX package's
    ``categorical(log(hist + 1e-20))``), representatives uniformly."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(1)
    act_w = stats.act_hist.reshape(-1).double().cpu() + 1e-20
    grp_w = stats.group_hist.reshape(-1).double().cpu() + 1e-20
    a_idx = torch.multinomial(act_w, n_mc, replacement=True, generator=gen)
    g_idx = torch.multinomial(grp_w, n_mc, replacement=True, generator=gen)
    reps = _reps(samples_per_group)
    r1 = torch.randint(0, reps.shape[1], (n_mc,), generator=gen)
    r2 = torch.randint(0, reps.shape[1], (n_mc,), generator=gen)
    dev = stats.act_hist.device
    return grouped_lut_from_draws(a_idx.to(dev), g_idx.to(dev), r1.to(dev),
                                  r2.to(dev), reps.to(dev), coeffs)


def trace_lut(stats: LayerStats) -> torch.Tensor:
    """Ground-truth per-weight LUT from the sampled trace, shape (256,)."""
    return stats.trace_lut()


def blended_lut(stats: LayerStats, **grouped_kwargs) -> torch.Tensor:
    """LUT used by the compression pipeline: trace where observed, grouped
    model as fallback for weight values never seen in the trace."""
    t = stats.trace_lut()
    g = grouped_model_lut(stats, **grouped_kwargs)
    return torch.where(stats.count > 0, t, g)


def model_fidelity(stats: LayerStats, **grouped_kwargs) -> dict:
    """Correlation diagnostics between the trace LUT and the grouped-model
    LUT over the weight values observed in the trace: pearson r, spearman
    (rank) r, and mean relative error."""
    seen = stats.count > 0
    tv = stats.trace_lut()[seen].double()
    gv = grouped_model_lut(stats, **grouped_kwargs)[seen].double()

    def _pearson(x, y):
        xm, ym = x - x.mean(), y - y.mean()
        denom = torch.sqrt((xm ** 2).sum() * (ym ** 2).sum())
        return float((xm * ym).sum() / torch.clamp(denom, min=1e-12))

    def _rank(x):
        ranks = torch.empty_like(x)
        ranks[torch.argsort(x)] = torch.arange(x.shape[0], dtype=x.dtype,
                                               device=x.device)
        return ranks

    return {"pearson": _pearson(tv, gv),
            "spearman": _pearson(_rank(tv), _rank(gv)),
            "mean_rel_err": float((torch.abs(tv - gv)
                                   / torch.clamp(tv, min=1e-9)).mean()),
            "n_seen": int(seen.sum())}


_UNIFORM_DRAWS: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}


def uniform_lut_from_draws(a_prev: torch.Tensor, a_cur: torch.Tensor,
                           p_prev: torch.Tensor,
                           coeffs: MacEnergyCoeffs = DEFAULT_COEFFS
                           ) -> torch.Tensor:
    """The uniform-trace LUT (256,) float32 from explicit draws: a_prev,
    a_cur (n,) int8-valued activations, p_prev (n,) 22-bit partial sums;
    ``p_cur = p_prev + w * a_cur`` (accumulate-consistent). The mean over
    the n draws is summed in float64 and rounded once."""
    w = torch.arange(-128, 128, dtype=torch.int32,
                     device=a_prev.device)[:, None]          # (256, 1)
    a_prev = a_prev.to(torch.int32)[None]
    a_cur = a_cur.to(torch.int32)[None]
    p_prev = p_prev.to(torch.int32)[None]
    e = mac_transition_energy(w, a_prev, a_cur, p_prev, p_prev + w * a_cur,
                              coeffs)                        # (256, n)
    return e.mean(dim=1, dtype=torch.float64).to(torch.float32)


def uniform_trace_lut(n_mc: int = 2048, seed: int = 23,
                      coeffs: MacEnergyCoeffs = DEFAULT_COEFFS, *,
                      device="cpu") -> torch.Tensor:
    """Traffic-agnostic per-weight-value LUT (256,) for serve-time
    estimates (port of `repro.core.energy_lut.uniform_trace_lut`).

    At serving time there are no profiled activation statistics, so the LM
    target Monte-Carlo-averages the MAC transition energy over *uniform*
    int8 activation transitions (a_prev, a_cur in [-128, 128)) with
    accumulate-consistent 22-bit partial sums (p_prev in [-2^21, 2^21)).
    Same units as `LayerStats.trace_lut`. The draws come from a CPU
    `torch.Generator` seeded with ``seed`` and are cached per process, so a
    seed gives the same LUT on every device."""
    key = (n_mc, seed)
    if key not in _UNIFORM_DRAWS:
        gen = torch.Generator().manual_seed(seed)
        _UNIFORM_DRAWS[key] = (
            torch.randint(-128, 128, (n_mc,), generator=gen),
            torch.randint(-128, 128, (n_mc,), generator=gen),
            torch.randint(-(1 << 21), 1 << 21, (n_mc,), generator=gen))
    draws = [d.to(device) for d in _UNIFORM_DRAWS[key]]
    return uniform_lut_from_draws(*draws, coeffs)
