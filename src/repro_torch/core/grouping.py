"""MSB x Hamming-weight grouping of the 22-bit partial-sum space (port of
`repro.core.grouping`, paper 3.1.1).

  Stage 1: MSB position (0..22, where 0 means value zero / no MSB) uniformly
           partitioned into ``N_MSB_GROUPS = 10`` groups.
  Stage 2: within each MSB group, Hamming weight partitioned into
           ``N_HD_SUBGROUPS = 5`` subgroups.

=> 50 groups. ``stability_ratio`` scores a grouping (a diagnostic of the
benchmarks).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bitops import PSUM_BITS, hamming_weight22, msb22

N_MSB_GROUPS = 10
N_HD_SUBGROUPS = 5
N_GROUPS = N_MSB_GROUPS * N_HD_SUBGROUPS

# MSB "value" in the paper's 0..22 range: 0 <=> zero value, k <=> msb index k-1.
_N_MSB_VALUES = PSUM_BITS + 1  # 23
_N_HW_VALUES = PSUM_BITS + 1   # Hamming weight in 0..22


def msb_group(p) -> torch.Tensor:
    """Stage-1 group in [0, N_MSB_GROUPS) from the 22-bit pattern of ``p``."""
    msb_val = msb22(p) + 1
    g = torch.div(msb_val * N_MSB_GROUPS, _N_MSB_VALUES, rounding_mode="floor")
    return torch.clamp(g, max=N_MSB_GROUPS - 1).to(torch.int32)


def hd_subgroup(p) -> torch.Tensor:
    """Stage-2 subgroup in [0, N_HD_SUBGROUPS) by Hamming weight."""
    hw = hamming_weight22(p)
    g = torch.div(hw * N_HD_SUBGROUPS, _N_HW_VALUES, rounding_mode="floor")
    return torch.clamp(g, max=N_HD_SUBGROUPS - 1).to(torch.int32)


def group_id(p) -> torch.Tensor:
    """Full group id in [0, 50) for a 22-bit partial sum pattern."""
    return msb_group(p) * N_HD_SUBGROUPS + hd_subgroup(p)


def group_transition_id(p_prev, p_cur) -> torch.Tensor:
    """Id in [0, 2500) of the (group(p_prev) -> group(p_cur)) transition."""
    return group_id(p_prev) * N_GROUPS + group_id(p_cur)


def stability_ratio(values, groups, n_groups: int = N_GROUPS) -> torch.Tensor:
    """Grouping-quality score: var(inter-group means) / mean(intra-group
    var), a 0-d float32 tensor. Higher is better (tight groups, well
    separated means).

    ``values`` are per-sample scalars (e.g. measured MAC energies),
    ``groups`` the group id of each sample. Empty groups are left out of
    both terms; the intra-group variance is biased and clamped at 0. The
    sums are taken in float64 and each term rounds to float32 once (the
    JAX package sums in float32)."""
    values = torch.as_tensor(values).to(torch.float64).reshape(-1)
    groups = torch.as_tensor(groups, device=values.device).long().reshape(-1)
    counts = torch.zeros(n_groups, dtype=torch.float64, device=values.device)
    sums = torch.zeros_like(counts)
    sq_sums = torch.zeros_like(counts)
    counts.index_add_(0, groups, torch.ones_like(values))
    sums.index_add_(0, groups, values)
    sq_sums.index_add_(0, groups, values * values)
    nonempty = counts > 0
    safe = torch.clamp(counts, min=1.0)
    means = sums / safe
    variances = torch.clamp(sq_sums / safe - means * means, min=0.0)
    n = max(int(nonempty.sum()), 1)
    m = means[nonempty]
    inter = ((m - m.sum() / n) ** 2).sum() / n
    intra = variances[nonempty].sum() / n
    return (inter / torch.clamp(intra, min=1e-12)).float()


def _randint(gen: torch.Generator, n: int) -> int:
    return int(torch.randint(0, n, (), generator=gen))


def group_representatives(generator: Optional[torch.Generator] = None,
                          samples_per_group: int = 8) -> torch.Tensor:
    """Representative 22-bit values for each of the 50 groups, (50, R) int32.

    The construction of the JAX package: for each (msb_group, hw_subgroup)
    cell pick an MSB position and a Hamming weight inside the cell, then set
    the remaining bits at uniformly drawn positions below the MSB. Cells that
    are combinatorially empty (hw > msb + 1) clamp to the closest feasible
    Hamming weight. The draws come from ``generator`` (a CPU
    `torch.Generator`; default seed 0) and differ from `jax.random`'s."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    reps = []
    for mg in range(N_MSB_GROUPS):
        msb_vals = [v for v in range(_N_MSB_VALUES)
                    if (v * N_MSB_GROUPS) // _N_MSB_VALUES == mg]
        for hg in range(N_HD_SUBGROUPS):
            hw_vals = [v for v in range(_N_HW_VALUES)
                       if min((v * N_HD_SUBGROUPS) // _N_HW_VALUES,
                              N_HD_SUBGROUPS - 1) == hg]
            cell = []
            for _ in range(samples_per_group):
                msb_val = msb_vals[_randint(gen, len(msb_vals))]
                hw = hw_vals[_randint(gen, len(hw_vals))]
                if msb_val == 0:
                    cell.append(0)
                    continue
                msb_pos = msb_val - 1
                hw = max(1, min(hw, msb_pos + 1))   # feasibility clamp
                val = 1 << msb_pos
                if msb_pos > 0 and hw > 1:
                    perm = torch.randperm(msb_pos, generator=gen)
                    for b in perm[: hw - 1].tolist():
                        val |= 1 << b
                cell.append(val)
            reps.append(cell)
    return torch.tensor(reps, dtype=torch.int32)
