"""Cycle-accurate weight-stationary systolic-array co-simulator (port of
`repro.cosim.systolic`).

This is the independent reference the transition-statistics kernel (K1) is
gated against (`repro_torch profile --verify-cosim`). It models the paper's
Sec. 3.1.1 array PE by PE and cycle by cycle:

  * weights are stationary: PE(r, c) holds ``w[r, c]``;
  * activations stream in skewed by ``r + c`` cycles, so at cycle ``u``
    PE(r, c) consumes ``a[r, u - r - c]`` (zero outside the stream);
  * each cycle a PE adds its product to the partial sum arriving from the
    PE above and latches the result:
    ``reg[r, c](u + 1) = reg[r - 1, c](u) + w[r, c] * a[r, u - r - c]``.

By induction PE(r, c)'s register holds the exact prefix sum
``S[r, c, t] = sum_{r' <= r} w[r', c] * a[r', t]`` at cycle
``r + c + t + 1``: the skewed cycle trace visits exactly the T values of the
unskewed prefix-sum trace, in t-order, per PE. The statistics are therefore
comparable 1:1 with the kernel's (which computes the unskewed trace
directly): per PE there are ``T - 1`` accumulator-register transitions, each
classified into one of the 50x50 (MSB group, Hamming subgroup) pairs.

Everything downstream of the trace uses the independent bit primitives of
`repro_torch.cosim.pe` (explicit 22-term bit sums, integer histograms): no
code shared with K1, its plain version, `core.bitops` or `core.grouping`.
The simulation runs on the tiles' own device, a batch of tiles in lockstep,
one register update a cycle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.cosim.pe import N_GROUPS, bits22, ref_group_id, \
    ref_popcount22

__all__ = [
    "pe_array_trace",
    "tile_cosim_stats",
    "cosim_batched_stats",
]

# bytes a chunk of tiles may hold in register history (one (K+M+T-2, K, M)
# int32 array a tile, about 3 MiB at 64^3) and in the activations entering
# each PE each cycle (as much again)
HISTORY_BYTES = 1 << 30


def _batched_trace(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """`pe_array_trace` of n tiles in lockstep: w (n, K, M), a (n, K, T)
    -> (n, K, M, T) int32."""
    w = w.to(torch.int32)
    a = a.to(torch.int32)
    n, k_dim, m_dim = w.shape
    n2, k2, t_len = a.shape
    if (n, k_dim) != (n2, k2):
        raise ValueError(f"w {tuple(w.shape)} and a {tuple(a.shape)} do not "
                         "pair up")
    dev = w.device
    rows = torch.arange(k_dim, device=dev)[:, None]              # (K, 1)
    cols = torch.arange(m_dim, device=dev)[None, :]              # (1, M)
    n_cycles = k_dim + m_dim + t_len - 2
    # the activation entering PE(r, c) at cycle u (skew r + c), every cycle
    t_idx = (torch.arange(n_cycles, device=dev)[:, None, None]
             - rows - cols)                                      # (U, K, M)
    valid = (t_idx >= 0) & (t_idx < t_len)
    a_in = torch.where(valid, a[:, rows, t_idx.clamp(0, t_len - 1)],
                       0)                                        # (n,U,K,M)
    # reg_hist[:, u] = register state after cycle u
    reg_hist = torch.empty((n, n_cycles, k_dim, m_dim), dtype=torch.int32,
                           device=dev)
    reg = torch.zeros((n, k_dim, m_dim), dtype=torch.int32, device=dev)
    for u in range(n_cycles):
        new = reg_hist[:, u]
        new[:, 0] = 0                      # row 0 receives 0 from above
        new[:, 1:] = reg[:, :-1]           # the partial sum handed down
        new += w * a_in[:, u]
        reg = new
    del a_in
    # PE(r, c) holds S[r, c, t] at cycle r + c + t + 1: reg_hist[:, r+c+t]
    r_i = rows[:, :, None]
    c_i = cols[:, :, None]
    t_i = torch.arange(t_len, device=dev)[None, None, :]
    return reg_hist[:, r_i + c_i + t_i, r_i, c_i]               # (n,K,M,T)


def pe_array_trace(w_tile: torch.Tensor, a_block: torch.Tensor
                   ) -> torch.Tensor:
    """Run the array cycle by cycle; return per-PE partial-sum sequences.

    Args:
      w_tile: (K, M) int weights, stationary (row r feeds activation r).
      a_block: (K, T) int activation stream, T output elements.

    Returns:
      (K, M, T) int32: the exact accumulator value PE(r, c) latches for
      output element t (read from the cycle-indexed register history at
      cycle ``r + c + t + 1``). Apply ``pe.bits22`` for the 22-bit
      hardware register view.
    """
    return _batched_trace(torch.as_tensor(w_tile)[None],
                          torch.as_tensor(a_block)[None])[0]


def _stats(psums: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 ((2500,) transition-pair counts, () toggles) of (..., T)
    partial-sum traces."""
    g = ref_group_id(psums)
    codes = (g[..., :-1] * N_GROUPS + g[..., 1:]).reshape(-1).to(torch.int64)
    hist = torch.zeros((N_GROUPS * N_GROUPS,), dtype=torch.int64,
                       device=psums.device)
    hist.scatter_add_(0, codes, torch.ones_like(codes))
    flipped = bits22(psums[..., :-1]) ^ bits22(psums[..., 1:])
    return hist, ref_popcount22(flipped).sum(dtype=torch.int64)


def tile_cosim_stats(w_tile: torch.Tensor, a_block: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bit-accurate per-tile statistics from the cycle trace.

    Returns:
      group_hist: (50, 50) int32, the count of accumulator transitions
        from group ``g_prev`` to ``g_cur`` (integer scatter-add, exact).
      toggles: () int32, the total bit flips of the 22-bit accumulator
        registers across all transitions (sum of XOR popcounts).
    """
    hist, toggles = _stats(pe_array_trace(w_tile, a_block))
    return (hist.to(torch.int32).reshape(N_GROUPS, N_GROUPS),
            toggles.to(torch.int32))


def chunk_tiles(k_dim: int, m_dim: int, t_len: int) -> int:
    """Tiles a chunk whose register history and per-cycle activations fit
    `HISTORY_BYTES`."""
    per_tile = 2 * (k_dim + m_dim + t_len - 2) * k_dim * m_dim * 4
    return max(1, HISTORY_BYTES // per_tile)


def cosim_batched_stats(
    w_tiles: torch.Tensor,
    a_blocks: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Co-simulate a tile batch; sum masked per-tile statistics.

    Mirrors `core.profiler.batched_layer_stats` semantics: zero-padded MACs
    inside a tile count (the padded PE still clocks), tiles with
    ``mask == 0`` contribute nothing. Runs on the tiles' own device, the
    batch in chunks of ``chunk`` tiles (default: as many as `chunk_tiles`
    allows) to bound the live register history, one (K+M+T-2, K, M) int32
    array a tile (about 3 MiB at 64^3). Sums in int64: no float anywhere.

    Returns ``(group_hist (50, 50) np.int64, toggles int)``.
    """
    w_tiles = torch.as_tensor(w_tiles)
    a_blocks = torch.as_tensor(a_blocks)
    if mask is not None:
        keep = torch.as_tensor(mask).to(w_tiles.device) != 0
        w_tiles, a_blocks = w_tiles[keep], a_blocks[keep]
    _, k_dim, m_dim = w_tiles.shape
    if chunk is None:
        chunk = chunk_tiles(k_dim, m_dim, a_blocks.shape[2])
    hist = torch.zeros((N_GROUPS * N_GROUPS,), dtype=torch.int64,
                       device=w_tiles.device)
    toggles = torch.zeros((), dtype=torch.int64, device=w_tiles.device)
    for lo in range(0, w_tiles.shape[0], chunk):
        h, t = _stats(_batched_trace(w_tiles[lo:lo + chunk],
                                     a_blocks[lo:lo + chunk]))
        hist += h
        toggles += t
    return (hist.cpu().numpy().reshape(N_GROUPS, N_GROUPS),
            int(toggles))
