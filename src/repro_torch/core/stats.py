"""im2col for NHWC activations (port of the im2col part of `repro.core.stats`).

The trace statistics (`LayerStats`, profiling) belong to the profile slice;
this module holds only the column layout that both the profiler and the
serve path (`repro_torch.core.export.serve_conv`) share.

Row order is ``k = (kh_i * kw + kw_i) * C_in + c``, which matches an HWIO
kernel reshaped to ``(kh*kw*C_in, C_out)``. `torch.nn.functional.unfold`
orders rows ``c * kh*kw + kh_i * kw + kw_i`` instead, so it is not used.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
    matrix the LUT-GEMM kernel reads, built in one allocation.
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
    cols = x.new_zeros((n, ho, wo, k_pad))
    for i in range(kh):
        for j in range(kw):
            o = (i * kw + j) * c
            cols[..., o:o + c] = x[:, i:i + (ho - 1) * stride + 1:stride,
                                   j:j + (wo - 1) * stride + 1:stride, :]
    return cols.reshape(n * ho * wo, k_pad)


def im2col(x: torch.Tensor, kernel_hw: Tuple[int, int], stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """im2col for NHWC input -> (kh*kw*Cin, N*Hout*Wout) columns (a
    transposed view of `im2col_rows`)."""
    return im2col_rows(x, kernel_hw, stride, padding).T


def conv_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel -> (C_out, kh*kw*C_in) matrix matching `im2col` rows."""
    return w.permute(3, 0, 1, 2).reshape(w.shape[3], -1)
