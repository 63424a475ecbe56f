"""Plain PyTorch version of the transition-statistics kernel (K1).

The port's counterpart of `repro.core.profiler.batched_stats_oracle`: for a
batch of stationary 64x64 tiles, each streaming T activation columns, the
prefix-sum psums of every MAC at t and t + 1 are priced by the MAC model and
reduced to four layer statistics. It computes what the CUDA kernel computes,
the same way: integer event sums per weight value, an integer group-pair
histogram and an integer activation-pair histogram (`transition_counts`),
priced and converted once by `finish_stats`. So kernel and plain version
agree bit for bit on all four outputs.

Tiles go through in chunks of `chunk_tiles` so the (chunk, 64, 64, T)
intermediates stay bounded: a whole 12,288-tile layer at T = 64 would need
12.9 GB for one int32 psum array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.bitops import MASK22, bit_length, popcount
from repro_torch.core.grouping import N_GROUPS, group_id
from repro_torch.core.mac_model import (
    DEFAULT_COEFFS,
    N_EVENTS,
    MacEnergyCoeffs,
    price_event_sums,
)
from repro_torch.core.stats import N_WVALS, TILE, StatsTuple

CountsTuple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_CHUNK_ELEMS = 1 << 23   # MAC-time elements per chunk (about 8.4 M)


def chunk_tiles(t_len: int) -> int:
    return max(1, _CHUNK_ELEMS // (TILE * TILE * t_len))


def _chunk_counts(w: torch.Tensor, a: torch.Tensor, events: torch.Tensor,
                  group_hist: torch.Tensor) -> None:
    """Add one chunk of (unmasked) tiles to the event sums and the group-pair
    histogram, in place. w (c, K, M), a (c, K, T) int32."""
    t_len = a.shape[2]
    wb = w[:, :, :, None]                                     # (c, K, M, 1)
    psums = torch.cumsum(wb * a[:, :, None, :], dim=1,
                         dtype=torch.int32)                   # (c, K, M, T)
    a_prev, a_cur = a[:, :, None, :-1], a[:, :, None, 1:]
    prod = popcount(((wb * a_prev) ^ (wb * a_cur)) & 0xFFFF).sum(-1)
    pp = (popcount((a_prev ^ a_cur) & 0xFF).sum(-1)
          * popcount(wb[..., 0] & 0xFF))
    dp = (psums[..., :-1] ^ psums[..., 1:]) & MASK22
    acc = popcount(dp).sum(-1)
    carry = bit_length(dp).sum(-1)
    n_trans = torch.full_like(acc, t_len - 1)
    per_mac = torch.stack([n_trans, prod, pp, acc, carry], -1)  # (c,K,M,5)
    bins = (w + 128).reshape(-1).to(torch.int64)
    events.index_add_(0, bins, per_mac.reshape(-1, N_EVENTS).to(torch.int64))

    g = group_id(psums)
    pairs = (g[..., :-1] * N_GROUPS + g[..., 1:]).reshape(-1)
    group_hist += torch.bincount(pairs, minlength=N_GROUPS * N_GROUPS)


def transition_counts(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> CountsTuple:
    """Integer statistics of a tile batch, summed over the tiles whose mask
    is not 0.

    w_tiles (n, 64, 64) int32 (K x M), a_blocks (n, 64, T) int32, mask (n,)
    or None. Returns int64 ``(events (256, 5), group_hist (2500,),
    act_hist (65536,))``: per weight value the transitions and the summed
    product, partial-product, accumulator and carry events
    (`repro_torch.core.mac_model.EVENTS`); the (g_prev * 50 + g_cur) and
    ((a_prev + 128) * 256 + a_cur + 128) pair counts."""
    dev = w_tiles.device
    if mask is not None:
        keep = mask != 0
        w_tiles, a_blocks = w_tiles[keep], a_blocks[keep]
    events = torch.zeros((N_WVALS, N_EVENTS), dtype=torch.int64, device=dev)
    group_hist = torch.zeros((N_GROUPS * N_GROUPS,), dtype=torch.int64,
                             device=dev)
    t_len = a_blocks.shape[2]
    step = chunk_tiles(t_len)
    for i in range(0, w_tiles.shape[0], step):
        _chunk_counts(w_tiles[i:i + step], a_blocks[i:i + step], events,
                      group_hist)
    act_pairs = ((a_blocks[:, :, :-1] + 128) * N_WVALS
                 + a_blocks[:, :, 1:] + 128).reshape(-1)
    act_hist = torch.bincount(act_pairs, minlength=N_WVALS * N_WVALS)
    return events, group_hist, act_hist


def finish_stats(events: torch.Tensor, group_hist: torch.Tensor,
                 act_hist: torch.Tensor,
                 coeffs: MacEnergyCoeffs = DEFAULT_COEFFS) -> StatsTuple:
    """Integer statistics -> the float32 ``(energy_sum (256,), count (256,),
    group_hist (50, 50), act_hist (256, 256))`` of the JAX kernel. Energy is
    priced once, in float64 (`price_event_sums`)."""
    return (price_event_sums(events, coeffs),
            events[:, 0].to(torch.float32),
            group_hist.to(torch.float32).reshape(N_GROUPS, N_GROUPS),
            act_hist.to(torch.float32).reshape(N_WVALS, N_WVALS))


def transition_stats_ref(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
                         coeffs: MacEnergyCoeffs = DEFAULT_COEFFS, *,
                         mask: Optional[torch.Tensor] = None) -> StatsTuple:
    """The four layer statistics of a tile batch (plain version of K1)."""
    return finish_stats(*transition_counts(w_tiles, a_blocks, mask), coeffs)
