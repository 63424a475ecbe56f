"""Bit-accurate systolic-array co-simulation oracle (port of `repro.cosim`).

An independent reference implementation of the paper's Sec. 3.1.1
weight-stationary PE array: cycle-accurate partial-sum register traces,
integer-only transition histograms and toggle counts, built on bit
primitives that share no code with the transition-statistics kernel (K1),
its plain version, `core.bitops` or `core.grouping`.
"""

from repro_torch.cosim.pe import (
    MASK22,
    N_GROUPS,
    N_HD_SUBGROUPS,
    N_MSB_GROUPS,
    PSUM_BITS,
    bits22,
    ref_group_id,
    ref_msb_val22,
    ref_popcount22,
)
from repro_torch.cosim.systolic import (
    cosim_batched_stats,
    pe_array_trace,
    tile_cosim_stats,
)
from repro_torch.cosim.verify import verify_runner_profile, verify_tiles

__all__ = [
    "MASK22",
    "N_GROUPS",
    "N_HD_SUBGROUPS",
    "N_MSB_GROUPS",
    "PSUM_BITS",
    "bits22",
    "ref_group_id",
    "ref_msb_val22",
    "ref_popcount22",
    "pe_array_trace",
    "tile_cosim_stats",
    "cosim_batched_stats",
    "verify_tiles",
    "verify_runner_profile",
]
