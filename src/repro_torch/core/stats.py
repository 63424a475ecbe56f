"""Layer-specific activation & partial-sum transition statistics (port of
`repro.core.stats`, paper 3.1.2), and the im2col layout shared by the
profiler and the serve path (`repro_torch.core.export.serve_conv`).

For every convolution/linear layer the profiler collects, from traced int8
activations and the layer's int8 weights:

  * the activation transition histogram  ``act_hist[256, 256]``
    (indexed by ``a_prev + 128`` / ``a_cur + 128``),
  * the grouped partial-sum transition histogram ``group_hist[50, 50]``
    (MSB x Hamming-weight groups of `repro_torch.core.grouping`),
  * the per-weight-value trace energy accumulators
    ``energy_sum[256]`` / ``count[256]``.

The trace follows the weight-stationary 64x64 systolic mapping: the weight
matrix W (M x K) is tiled into (64-K x 64-M) stationary tiles, an activation
block X (64-K x T) streams through, and MAC (r, c) holds
``S[r, c, t] = sum_{r' <= r} W_tile[r', c] * A[r', t]`` in its accumulator.
Transitions are taken along t (the streaming axis).

im2col row order is ``k = (kh_i * kw + kw_i) * C_in + c``, which matches an
HWIO kernel reshaped to ``(kh*kw*C_in, C_out)``. `torch.nn.functional.unfold`
orders rows ``c * kh*kw + kh_i * kw + kw_i`` instead, so it is not used.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.grouping import N_GROUPS
from repro_torch.core.mac_model import DEFAULT_COEFFS, MacEnergyCoeffs

TILE = 64      # systolic array dimension (64x64 weight-stationary, paper 3.2)
N_WVALS = 256  # int8 weight values, indexed by w + 128

StatsTuple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass
class LayerStats:
    """Accumulated transition statistics for one layer (float32 tensors)."""

    act_hist: torch.Tensor     # (256, 256) counts
    group_hist: torch.Tensor   # (50, 50) counts
    energy_sum: torch.Tensor   # (256,) summed transition energy per weight value
    count: torch.Tensor        # (256,) number of transitions per weight value
    n_transitions: int         # total transitions traced

    def act_probs(self) -> torch.Tensor:
        return self.act_hist / torch.clamp(self.act_hist.sum(), min=1.0)

    def group_probs(self) -> torch.Tensor:
        return self.group_hist / torch.clamp(self.group_hist.sum(), min=1.0)

    def trace_lut(self) -> torch.Tensor:
        """Per-weight-value average transition energy; zero-count -> mean
        fill."""
        lut = self.energy_sum / torch.clamp(self.count, min=1.0)
        seen = self.count > 0
        mean_seen = (torch.where(seen, lut, torch.zeros_like(lut)).sum()
                     / torch.clamp(seen.sum(), min=1))
        return torch.where(seen, lut, mean_seen)

    def to(self, device) -> "LayerStats":
        return LayerStats(self.act_hist.to(device), self.group_hist.to(device),
                          self.energy_sum.to(device), self.count.to(device),
                          self.n_transitions)


def empty_stats(device="cpu") -> LayerStats:
    return LayerStats(
        act_hist=torch.zeros((N_WVALS, N_WVALS), device=device),
        group_hist=torch.zeros((N_GROUPS, N_GROUPS), device=device),
        energy_sum=torch.zeros((N_WVALS,), device=device),
        count=torch.zeros((N_WVALS,), device=device),
        n_transitions=0,
    )


def tile_psum_trace(w_tile: torch.Tensor, a_block: torch.Tensor
                    ) -> torch.Tensor:
    """Partial-sum trace S[r, c, t] of one weight-stationary tile.

    w_tile: (K_t, M_t) int — stationary weights (rows = reduction dim)
    a_block: (K_t, T) int  — streamed activation columns
    returns (K_t, M_t, T) int32 partial sums (22-bit range by construction).
    """
    prods = (w_tile.to(torch.int32)[:, :, None]
             * a_block.to(torch.int32)[:, None, :])
    return torch.cumsum(prods, dim=0, dtype=torch.int32)


def tile_transition_stats(w_tile: torch.Tensor, a_block: torch.Tensor,
                          coeffs: MacEnergyCoeffs = DEFAULT_COEFFS
                          ) -> StatsTuple:
    """Trace one tile; return (energy_sum[256], count[256], group_hist,
    act_hist). A batch of one through the transition-statistics kernel's
    device dispatch (`repro_torch.kernels.transition_energy.ops`)."""
    from repro_torch.kernels.transition_energy import ops

    return ops.tile_transition_stats(w_tile, a_block, coeffs)


def pad_to_tiles(w_mat: torch.Tensor, x_cols: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad W (M, K) and X (K, N) up to multiples of TILE."""
    m, k = w_mat.shape
    k2, n = x_cols.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {k} vs {k2}")
    # F.pad lists dims last-first: (cols lo, cols hi, rows lo, rows hi)
    w_pad = F.pad(w_mat, (0, (-k) % TILE, 0, (-m) % TILE))
    x_pad = F.pad(x_cols, (0, (-n) % TILE, 0, (-k) % TILE))
    return w_pad, x_pad


def collect_layer_stats(w_mat: torch.Tensor, x_cols: torch.Tensor, *,
                        max_tiles: int = 48, seed: int = 0,
                        coeffs: MacEnergyCoeffs = DEFAULT_COEFFS
                        ) -> LayerStats:
    """Trace a layer's matmul on the 64x64 array and accumulate statistics
    (`repro_torch.core.profiler.profile_layer`)."""
    from repro_torch.core.profiler import profile_layer

    return profile_layer(w_mat, x_cols, max_tiles=max_tiles, seed=seed,
                         coeffs=coeffs)


def conv_out_hw(h: int, w: int, kernel_hw: Tuple[int, int], stride: int,
                padding: str) -> Tuple[int, int]:
    """Output spatial size of a conv under JAX's SAME / VALID rules."""
    kh, kw = kernel_hw
    if padding == "SAME":
        return -(-h // stride), -(-w // stride)
    if padding == "VALID":
        return (h - kh) // stride + 1, (w - kw) // stride + 1
    raise ValueError(padding)


def same_pad_nhwc(x: torch.Tensor, kernel_hw: Tuple[int, int],
                  stride: int) -> torch.Tensor:
    """Zero-pad H and W the way `lax.conv` SAME does: the total padding
    ``max((out-1)*stride + k - in, 0)`` split low ``total // 2`` / high the
    rest, so stride-2 convs on even sizes pad asymmetrically."""
    kh, kw = kernel_hw
    _, h, w, _ = x.shape
    ho, wo = conv_out_hw(h, w, kernel_hw, stride, "SAME")
    pad_h = max((ho - 1) * stride + kh - h, 0)
    pad_w = max((wo - 1) * stride + kw - w, 0)
    if not (pad_h or pad_w):
        return x
    # F.pad lists dims last-first: (C lo, C hi, W lo, W hi, H lo, H hi)
    return F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                     pad_h // 2, pad_h - pad_h // 2))


def im2col_rows(x: torch.Tensor, kernel_hw: Tuple[int, int], stride: int = 1,
                padding: str = "SAME",
                k_pad: Optional[int] = None) -> torch.Tensor:
    """NHWC input -> contiguous ``(N*Hout*Wout, K_pad)`` patch rows.

    Columns ``[0, kh*kw*C)`` follow the `im2col` row order; columns up to
    ``k_pad`` (default: no padding) are zero. This is the row-major ``(M, K)``
    matrix the LUT-GEMM kernel reads (the serve path asks for K rounded up
    to 8), built in one allocation; only the padding columns are zeroed.
    """
    kh, kw = kernel_hw
    n, h, w, c = x.shape
    ho, wo = conv_out_hw(h, w, kernel_hw, stride, padding)
    if padding == "SAME":
        x = same_pad_nhwc(x, kernel_hw, stride)
    k = kh * kw * c
    k_pad = k if k_pad is None else k_pad
    if k_pad < k:
        raise ValueError(f"k_pad={k_pad} < K={k}")
    # (N, Ho, Wo, C, kh, kw) windows: a view of x, gathered by one copy
    win = x.unfold(1, kh, stride).unfold(2, kw, stride)[:, :ho, :wo]
    cols = x.new_empty((n, ho, wo, k_pad))
    cols[..., :k].unflatten(-1, (kh, kw, c)).copy_(
        win.permute(0, 1, 2, 4, 5, 3))
    if k_pad > k:
        cols[..., k:] = 0
    return cols.reshape(n * ho * wo, k_pad)


def im2col(x: torch.Tensor, kernel_hw: Tuple[int, int], stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """im2col for NHWC input -> (kh*kw*Cin, N*Hout*Wout) columns (a
    transposed view of `im2col_rows`)."""
    return im2col_rows(x, kernel_hw, stride, padding).T


def conv_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel -> (C_out, kh*kw*C_in) matrix matching `im2col` rows."""
    return w.permute(3, 0, 1, 2).reshape(w.shape[3], -1)
