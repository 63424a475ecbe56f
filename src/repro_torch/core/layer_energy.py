"""Systolic matmul dimensions of a layer (port of the dims part of
`repro.core.layer_energy`).

im2col turns each conv into ``Y = W_mat @ X_col`` with ``W_mat`` (M x K),
``X_col`` (K x N): M = C_out, K = C_in*k^2, N = H_out*W_out*batch. The
energy model itself (`weight_value_counts`, `LayerEnergyModel`) belongs to
the profile slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

TILE = 64  # systolic array dimension (64x64 weight-stationary, paper 3.2)


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
