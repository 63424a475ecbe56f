"""Device dispatch of the transition-statistics kernel (port of
`repro.kernels.transition_energy.ops`).

`batched_transition_stats` (K1), `batched_transition_counts` (K1's integer
statistics, unpriced) and `tile_transition_stats` (K1b, a batch of one)
check their inputs, then dispatch by the device of the tensors: CPU
tensors take the plain version (`ref.py`), CUDA tensors launch the
hand-written kernel (`transition_energy.py`) or raise. Both routes return
integer statistics that `ref.finish_stats` prices and converts once, so the
two agree bit for bit. The JAX wrapper's ``interpret`` knob has no
counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.mac_model import DEFAULT_COEFFS, MacEnergyCoeffs
from repro_torch.core.stats import TILE, StatsTuple
from repro_torch.kernels.transition_energy import ref
from repro_torch.kernels.transition_energy import transition_energy as _kernel


def check_inputs(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
                 mask: torch.Tensor) -> None:
    """Raise `ValueError` on anything the kernel does not take: shapes (the
    TPU kernel's asserts), dtype, device, contiguity, 2 <= T <= MAX_T, and
    values outside the int8 range (they would index past the histograms)."""
    if w_tiles.ndim != 3 or tuple(w_tiles.shape[1:]) != (TILE, TILE):
        raise ValueError(f"w_tiles must be (n, {TILE}, {TILE}), got "
                         f"{tuple(w_tiles.shape)}")
    n = w_tiles.shape[0]
    if a_blocks.ndim != 3 or tuple(a_blocks.shape[:2]) != (n, TILE):
        raise ValueError(f"a_blocks must be ({n}, {TILE}, T), got "
                         f"{tuple(a_blocks.shape)}")
    t_len = a_blocks.shape[2]
    if not 2 <= t_len <= _kernel.MAX_T:
        raise ValueError(f"T={t_len} streamed columns; need 2 <= T <= "
                         f"{_kernel.MAX_T}")
    if tuple(mask.shape) != (n,):
        raise ValueError(f"mask shape {tuple(mask.shape)} != ({n},)")
    for name, t, dtype in (("w_tiles", w_tiles, torch.int32),
                           ("a_blocks", a_blocks, torch.int32),
                           ("mask", mask, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != w_tiles.device:
            raise ValueError(f"{name} is on {t.device}, w_tiles on "
                             f"{w_tiles.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous; build it contiguous "
                             "(no strided views)")
    for name, t in (("w_tiles", w_tiles), ("a_blocks", a_blocks)):
        if t.numel():
            lo, hi = torch.aminmax(t)
            if int(lo) < -128 or int(hi) > 127:
                raise ValueError(f"{name} holds values outside the int8 "
                                 "range")


def batched_transition_counts(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
                              *, mask: Optional[torch.Tensor] = None
                              ) -> ref.CountsTuple:
    """The integer statistics of a tile batch in one kernel launch, before
    pricing: int64 ``(events (256, 5), group_hist (2500,), act_hist
    (65536,))`` (`ref.transition_counts`). Inputs as
    `batched_transition_stats`."""
    if mask is None:
        mask = torch.ones((w_tiles.shape[0],), dtype=torch.float32,
                          device=w_tiles.device)
    check_inputs(w_tiles, a_blocks, mask)
    if w_tiles.device.type == "cuda":
        return _kernel.launch(w_tiles, a_blocks, mask)
    if w_tiles.device.type == "cpu":
        return ref.transition_counts(w_tiles, a_blocks, mask)
    raise ValueError(f"unsupported device {w_tiles.device}")


def batched_transition_stats(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
                             coeffs: MacEnergyCoeffs = DEFAULT_COEFFS, *,
                             mask: Optional[torch.Tensor] = None
                             ) -> StatsTuple:
    """Whole-tile-batch statistics in one kernel launch.

    w_tiles (n, 64, 64) int32 stationary tiles (K x M), a_blocks (n, 64, T)
    int32 streamed activations, mask (n,) float32 or None; tiles whose mask
    is 0 contribute nothing (any other value counts the tile once). Returns
    float32 ``(energy_sum (256,), count (256,), group_hist (50, 50),
    act_hist (256, 256))`` summed over the batch."""
    return ref.finish_stats(
        *batched_transition_counts(w_tiles, a_blocks, mask=mask), coeffs)


def tile_transition_stats(w_tile: torch.Tensor, a_block: torch.Tensor,
                          coeffs: MacEnergyCoeffs = DEFAULT_COEFFS
                          ) -> StatsTuple:
    """One tile's statistics (K1b): w_tile (64, 64), a_block (64, T), both
    int32. A batch of one through `batched_transition_stats`."""
    return batched_transition_stats(w_tile[None], a_block[None], coeffs)
