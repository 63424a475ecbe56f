"""Convolution/linear layer energy via the tile-level systolic mapping
(port of `repro.core.layer_energy`, paper 3.2).

im2col turns each conv into ``Y = W_mat @ X_col`` with ``W_mat`` (M x K),
``X_col`` (K x N): M = C_out, K = C_in*k^2, N = H_out*W_out*batch. The
matmul is partitioned into 64x64 weight-stationary tiles; each (m, k) weight
tile is streamed with ceil(N/64) activation blocks of 128 cycles (64 fill +
64 drain at unit clock), so

    E_layer = sum_w counts_padded(w) * LUT(w) * (2 * T) * ceil(N/64)

where ``counts_padded`` counts each weight once per (m, k) tile including the
zero padding of partial tiles (padded MACs hold w = 0 and still clock).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.core.stats import N_WVALS, TILE

CLOCK_F = 1.0
T_CYCLES = TILE / CLOCK_F          # paper: T = 64 / f
PASS_ENERGY_SCALE = 2.0 * T_CYCLES  # paper: E_tile = 2 * P_tile * T


@dataclass(frozen=True)
class MatmulDims:
    """Dimensions of a layer's matmul as mapped on the systolic array."""

    m: int  # output channels / features
    k: int  # reduction (C_in * k_h * k_w, or fan-in)
    n: int  # streamed columns (H_out * W_out * batch, or tokens)

    @property
    def m_tiles(self) -> int:
        return -(-self.m // TILE)

    @property
    def k_tiles(self) -> int:
        return -(-self.k // TILE)

    @property
    def n_tiles(self) -> int:
        return -(-self.n // TILE)

    @property
    def total_tiles(self) -> int:
        return self.m_tiles * self.k_tiles * self.n_tiles

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


def conv_matmul_dims(c_in: int, c_out: int, kernel_hw: Tuple[int, int],
                     out_hw: Tuple[int, int], batch: int = 1) -> MatmulDims:
    kh, kw = kernel_hw
    ho, wo = out_hw
    return MatmulDims(m=c_out, k=c_in * kh * kw, n=ho * wo * batch)


def dense_matmul_dims(fan_in: int, fan_out: int, n_tokens: int) -> MatmulDims:
    return MatmulDims(m=fan_out, k=fan_in, n=n_tokens)


def weight_value_counts(w_int: torch.Tensor, dims: MatmulDims) -> torch.Tensor:
    """Histogram (256,) float32 of int8 weight values over the *padded*
    weight matrix; the zero padding of partial tiles adds to w = 0."""
    w_flat = w_int.reshape(-1).to(torch.int64)
    counts = torch.bincount(w_flat + 128, minlength=N_WVALS).to(torch.float32)
    pad_zeros = dims.m_tiles * dims.k_tiles * TILE * TILE - w_flat.shape[0]
    counts[128] += pad_zeros
    return counts


def layer_energy_from_counts(counts: torch.Tensor, lut: torch.Tensor,
                             dims: MatmulDims) -> torch.Tensor:
    """E_layer = sum_w counts(w) * LUT(w) * 2T * ceil(N/64)  (scalar, eu)."""
    return (counts * lut).sum() * PASS_ENERGY_SCALE * dims.n_tiles


def layer_energy(w_int: torch.Tensor, lut: torch.Tensor,
                 dims: MatmulDims) -> torch.Tensor:
    return layer_energy_from_counts(weight_value_counts(w_int, dims), lut,
                                    dims)


def tile_power(counts: torch.Tensor, lut: torch.Tensor,
               dims: MatmulDims) -> torch.Tensor:
    """P_tile^(l): average per-tile power (paper 3.2), for reporting."""
    return (counts * lut).sum() / max(dims.m_tiles * dims.k_tiles, 1)


def tile_energy(counts: torch.Tensor, lut: torch.Tensor,
                dims: MatmulDims) -> torch.Tensor:
    """E_tile = 2 * P_tile * T."""
    return PASS_ENERGY_SCALE * tile_power(counts, lut, dims)


def delta_energy_remove(counts: torch.Tensor, lut: torch.Tensor,
                        dims: MatmulDims, w_value: int,
                        nearest_value: int) -> torch.Tensor:
    """Energy delta (> 0 = saving) of disallowing ``w_value`` in this layer,
    all its occurrences remapped to ``nearest_value`` (paper 4.2.2 (i))."""
    w_idx, n_idx = int(w_value) + 128, int(nearest_value) + 128
    per_pass = counts[w_idx] * (lut[w_idx] - lut[n_idx])
    return per_pass * PASS_ENERGY_SCALE * dims.n_tiles


@dataclass
class LayerEnergyModel:
    """Everything the scheduler needs to reason about one layer's energy."""

    name: str
    dims: MatmulDims
    lut: torch.Tensor       # (256,) per-weight-value per-cycle energy
    counts: torch.Tensor    # (256,) current weight-value histogram (padded)

    @property
    def energy(self) -> float:
        return float(layer_energy_from_counts(self.counts, self.lut,
                                              self.dims))

    def with_counts(self, counts: torch.Tensor) -> "LayerEnergyModel":
        return LayerEnergyModel(self.name, self.dims, self.lut, counts)


def energy_shares(models: List[LayerEnergyModel]) -> torch.Tensor:
    """rho_l = E_l / sum_j E_j (paper 4.3)."""
    e = torch.tensor([m.energy for m in models], dtype=torch.float32)
    return e / torch.clamp(e.sum(), min=1e-12)
