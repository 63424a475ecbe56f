"""Bit-level primitives for the processing-element co-simulator (port of
`repro.cosim.pe`).

Everything here is deliberately *independent* of the transition-statistics
kernel (K1), of its plain version and of `repro_torch.core.bitops`: no SWAR
population count, no smeared bit length, no shared helpers. Popcount and MSB
position are explicit 22-term bit sums, so a fault in K1's bit tricks (or in
the plain version's, which share `core.bitops`) cannot cancel out between
the kernel and this reference. The only shared artifacts are the published
constants of the grouping spec (22-bit accumulator, 10 MSB groups, 5 Hamming
subgroups) from the paper's Sec. 3.1.1.
"""

from __future__ import annotations

import torch

PSUM_BITS = 22
MASK22 = (1 << PSUM_BITS) - 1
N_MSB_GROUPS = 10
N_HD_SUBGROUPS = 5
N_GROUPS = N_MSB_GROUPS * N_HD_SUBGROUPS


def bits22(x) -> torch.Tensor:
    """The 22-bit accumulator view of an int32 partial sum (two's complement
    truncation, always non-negative)."""
    return torch.as_tensor(x).to(torch.int32) & MASK22


def ref_popcount22(x) -> torch.Tensor:
    """Hamming weight of the 22-bit view, as a sum of 22 single-bit tests."""
    v = bits22(x)
    total = torch.zeros_like(v)
    for b in range(PSUM_BITS):
        total += (v >> b) & 1
    return total


def ref_msb_val22(x) -> torch.Tensor:
    """1-based index of the highest set bit of the 22-bit view; 0 when the
    masked value is zero. Computed as ``sum_b [v >= 2^b]``: a monotone
    threshold count, no count-leading-zeros anywhere."""
    v = bits22(x)
    total = torch.zeros_like(v)
    for b in range(PSUM_BITS):
        total += (v >= (1 << b)).to(torch.int32)
    return total


def ref_group_id(p) -> torch.Tensor:
    """Energy-group id (0..49) of one partial-sum value: coarse MSB group
    times 5 plus Hamming-weight subgroup. Shares no code with the kernel's
    or the plain version's group id."""
    msb_val = ref_msb_val22(p)                       # 0..22
    mg = torch.clamp(msb_val * N_MSB_GROUPS // (PSUM_BITS + 1),
                     max=N_MSB_GROUPS - 1)
    hw = ref_popcount22(p)                           # 0..22
    hg = torch.clamp(hw * N_HD_SUBGROUPS // (PSUM_BITS + 1),
                     max=N_HD_SUBGROUPS - 1)
    return mg * N_HD_SUBGROUPS + hg
