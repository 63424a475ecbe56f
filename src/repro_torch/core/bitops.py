"""Bit-level utilities for the MAC switching-activity model (port of
`repro.core.bitops`).

All helpers operate on integer tensors holding *bit patterns*:

- 8-bit operands (weights / activations) are stored as their two's-complement
  bit pattern in the low 8 bits (``x & 0xFF``).
- 16-bit products use the low 16 bits.
- 22-bit partial sums (the accumulator width of the paper's 64x64
  weight-stationary array) use the low 22 bits.

PyTorch has no population count or count-leading-zeros, so `popcount` is a
SWAR bit count and `bit_length` smears the top set bit downwards and counts.
Both work on the 32-bit two's-complement pattern of their input in int32:
the sign bit is split off first, so no shift ever sees a negative value,
and negative values count the way ``lax.population_count`` counts them.
"""

from __future__ import annotations

import torch

# Accumulator width of the systolic array in the paper (Section 3.1):
# 8b x 8b products accumulated over a 64-row column need 16 + log2(64) = 22 bits.
PSUM_BITS = 22
MASK22 = (1 << PSUM_BITS) - 1  # 0x3FFFFF
MASK16 = (1 << 16) - 1
MASK8 = (1 << 8) - 1
_LOW31 = (1 << 31) - 1


def _int32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def to_bits8(x) -> torch.Tensor:
    """Two's-complement 8-bit pattern of an int tensor, as int32 in [0, 255]."""
    return _int32(x) & MASK8


def to_bits16(x) -> torch.Tensor:
    """Two's-complement 16-bit pattern (products of 8b x 8b)."""
    return _int32(x) & MASK16


def to_bits22(x) -> torch.Tensor:
    """Two's-complement 22-bit pattern (partial sums)."""
    return _int32(x) & MASK22


def popcount(x) -> torch.Tensor:
    """Number of set bits of the 32-bit pattern (int in, int32 out)."""
    x = _int32(x)
    v = x & _LOW31                                # non-negative: plain shifts
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = (v + (v >> 8) + (v >> 16) + (v >> 24)) & 0x3F
    return v + (x < 0).to(torch.int32)


def bit_length(x) -> torch.Tensor:
    """``32 - clz`` of the 32-bit pattern: 1 + the index of the most
    significant set bit, 0 for zero."""
    x = _int32(x)
    v = x & _LOW31
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return torch.where(x < 0, torch.full_like(x, 32), popcount(v))


def hamming_distance(x, y) -> torch.Tensor:
    """Hamming distance between two equally-masked bit patterns."""
    return popcount(_int32(x) ^ _int32(y))


def hamming_weight22(p) -> torch.Tensor:
    """Hamming weight of the 22-bit pattern of a partial sum."""
    return popcount(to_bits22(p))


def msb22(p) -> torch.Tensor:
    """Index of the most significant set bit of the 22-bit pattern.

    Returns -1 for zero (no bit set), else a value in [0, 21]. The mask
    applies before the zero test, so any value that is zero modulo 2**22
    returns -1."""
    return bit_length(to_bits22(p)) - 1


def carry_chain_length(p_prev, p_cur) -> torch.Tensor:
    """Length of the accumulator region disturbed by a transition: 1 + msb
    of the toggled-bit pattern (0 when nothing toggles)."""
    diff = to_bits22(_int32(p_prev) ^ _int32(p_cur))
    return msb22(diff) + 1
