"""Bit-level MAC switching-energy model (port of `repro.core.mac_model`).

Energy of one MAC cycle transition, for a stationary weight ``w`` observing
activation transition ``a -> a'`` and partial-sum transition ``p -> p'``::

    E = c_prod  * HD(w*a, w*a')            # product register toggles (16b)
      + c_pp    * HD8(a, a') * HW8(w)      # partial-product array activity
      + c_acc   * HD22(p, p')              # accumulator register toggles
      + c_carry * carry_chain(p, p')       # carry propagation to the top
                                           #   toggled bit
      + c_base                             # clock floor, every cycle

For w == 0 the array is zero-gated: the multiplier terms vanish and the
accumulator is bypassed with a latch, ``c_zero * HD22(p, p') + c_base``.

The energy is linear in four integer event counts (product toggles, partial-
product activity, accumulator toggles, carry length) with a branch fixed by
the weight, which is what lets the transition-statistics kernel sum integers
per weight value and price them once (`price_event_sums`).
`weight_static_energy_profile` is the paper's Fig. 1 profile.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.bitops import (
    carry_chain_length,
    hamming_distance,
    popcount,
    to_bits8,
    to_bits16,
    to_bits22,
)


@dataclass(frozen=True)
class MacEnergyCoeffs:
    """Per-event switching energies, in arbitrary 'energy units' (eu)."""

    c_prod: float = 1.00   # per toggled product-register bit
    c_pp: float = 0.18     # per (activation-bit toggle x weight set bit)
    c_acc: float = 0.80    # per toggled accumulator bit
    c_carry: float = 0.55  # per carry-chain stage reached
    c_zero: float = 0.12   # bypass-latch toggle for zero (pruned) weights
    c_base: float = 0.02   # clock-tree / sequencing floor per cycle


DEFAULT_COEFFS = MacEnergyCoeffs()


def mac_transition_energy(w, a_prev, a_cur, p_prev, p_cur,
                          coeffs: MacEnergyCoeffs = DEFAULT_COEFFS
                          ) -> torch.Tensor:
    """Energy (eu, float32) of one MAC transition. All inputs are integer
    tensors that broadcast together: ``w``, ``a_prev``, ``a_cur``
    int8-valued, ``p_prev``, ``p_cur`` 22-bit partial sums."""
    w = torch.as_tensor(w).to(torch.int32)
    a_prev = torch.as_tensor(a_prev).to(torch.int32)
    a_cur = torch.as_tensor(a_cur).to(torch.int32)

    t_prod = hamming_distance(to_bits16(w * a_prev),
                              to_bits16(w * a_cur)).to(torch.float32)
    t_pp = (hamming_distance(to_bits8(a_prev), to_bits8(a_cur))
            * popcount(to_bits8(w))).to(torch.float32)
    t_acc = hamming_distance(to_bits22(p_prev),
                             to_bits22(p_cur)).to(torch.float32)
    t_carry = carry_chain_length(p_prev, p_cur).to(torch.float32)

    active = (coeffs.c_prod * t_prod + coeffs.c_pp * t_pp
              + coeffs.c_acc * t_acc + coeffs.c_carry * t_carry)
    gated = coeffs.c_zero * t_acc
    return torch.where(w == 0, gated, active) + coeffs.c_base


# columns of an event-sum table: (256 weight values, N_EVENTS)
EVENTS = ("transitions", "prod", "pp", "acc", "carry")
N_EVENTS = len(EVENTS)


def price_event_sums(events: torch.Tensor,
                     coeffs: MacEnergyCoeffs = DEFAULT_COEFFS
                     ) -> torch.Tensor:
    """Summed transition energy per weight value from integer event sums.

    ``events`` is (256, N_EVENTS) integer, row ``w + 128``, columns
    `EVENTS`: the number of transitions and the summed product toggles,
    partial-product activity, accumulator toggles and carry lengths of the
    MACs holding that weight. Prices them once in float64 with the
    `mac_transition_energy` formula (row 128 is the zero-gated branch) and
    rounds to float32."""
    e = events.to(torch.float64)
    active = (coeffs.c_prod * e[:, 1] + coeffs.c_pp * e[:, 2]
              + coeffs.c_acc * e[:, 3] + coeffs.c_carry * e[:, 4])
    gated = coeffs.c_zero * e[:, 3]
    is_zero = torch.arange(events.shape[0], device=events.device) == 128
    energy = torch.where(is_zero, gated, active) + coeffs.c_base * e[:, 0]
    return energy.to(torch.float32)


def weight_static_energy_profile(coeffs: MacEnergyCoeffs = DEFAULT_COEFFS,
                                 n_samples: int = 4096, seed: int = 0, *,
                                 a_seq: Optional[torch.Tensor] = None,
                                 p_seq: Optional[torch.Tensor] = None,
                                 device=None) -> torch.Tensor:
    """Mean MAC transition energy of every int8 weight under uniform random
    traffic (the paper's Fig. 1 setting: random transitions, a fixed
    weight), float32 (256,) indexed by ``w + 128``.

    ``a_seq`` ((n_samples + 1,) activations in [-128, 128)) and ``p_seq``
    ((n_samples + 1,) 22-bit partial sums) default to draws from a
    `torch.Generator` seeded with ``seed`` on ``device`` (the JAX package
    draws them from `jax.random`, which torch cannot replay; a test passes
    JAX's sequences in). Each weight's mean is summed in float64 and
    rounded once."""
    if a_seq is None or p_seq is None:
        dev = torch.device(device if device is not None else "cpu")
        gen = torch.Generator(device=dev).manual_seed(seed)
        if a_seq is None:
            a_seq = torch.randint(-128, 128, (n_samples + 1,),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
        if p_seq is None:
            p_seq = torch.randint(0, 1 << 22, (n_samples + 1,),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
    a_seq = torch.as_tensor(a_seq).to(torch.int32)
    p_seq = torch.as_tensor(p_seq).to(device=a_seq.device, dtype=torch.int32)
    w = torch.arange(-128, 128, dtype=torch.int32,
                     device=a_seq.device)[:, None]
    e = mac_transition_energy(w, a_seq[None, :-1], a_seq[None, 1:],
                              p_seq[None, :-1], p_seq[None, 1:], coeffs)
    return e.mean(dim=1, dtype=torch.float64).float()
