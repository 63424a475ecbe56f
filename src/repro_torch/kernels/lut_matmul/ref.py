"""Plain PyTorch version of the 4-bit codebook-index GEMM (+ fused epilogue).

Port of `repro.kernels.lut_matmul.ref`. The CPU path of
`repro_torch.kernels.lut_matmul.ops` runs it, and the on-card check holds the
CUDA kernel against it on the same inputs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

N_CODES = 16

# epilogue activations the kernel fuses; keys are the public contract shared
# with the eager layers (`repro_torch.nn.layers`). gelu is the tanh form, as
# in the JAX package (jax.nn.gelu(approximate=True)).
ACTIVATIONS = {
    "none": lambda v: v,
    "relu": torch.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "silu": F.silu,
}


def unpack_indices(packed: torch.Tensor, block_k: int) -> torch.Tensor:
    """Invert `ops.pack_indices`: (K//2, N) int8 -> (K, N) int32 indices.

    Packing is block-local over K blocks of ``block_k``: within each block,
    byte row j holds index rows j (low nibble) and j + block_k/2 (high). The
    signed byte is widened and masked with 0xFF before the high-nibble shift,
    so a set sign bit never leaks into the index.
    """
    k2, n = packed.shape
    k = 2 * k2
    if k % block_k != 0:
        raise ValueError(f"K={k} is not a multiple of block_k={block_k}")
    p = packed.to(torch.int32) & 0xFF
    p = p.reshape(k // block_k, block_k // 2, n)
    low = p & 0xF
    high = (p >> 4) & 0xF
    return torch.cat([low, high], dim=1).reshape(k, n)


def dequantize(packed: torch.Tensor, codebook: torch.Tensor,
               scale: torch.Tensor, block_k: int) -> torch.Tensor:
    """(K//2, N) packed indices -> (K, N) float32 weights
    ``codebook[idx] * scale[n]``."""
    idx = unpack_indices(packed, block_k)
    return codebook.float()[idx.long()] * scale.float()[None, :]


def weight_rows(w: torch.Tensor, k_x: int) -> torch.Tensor:
    """The first ``k_x`` rows of a dequantized (K_pad, N) weight, the rows an
    (M, K_x) X multiplies: X's columns [K_x, K_pad) count as zero, and rows
    past K_pad (K_x is K rounded up to 8) as zero weights."""
    k_pad = w.shape[0]
    if k_x <= k_pad:
        return w[:k_x]
    return torch.cat([w, w.new_zeros((k_x - k_pad, w.shape[1]))])


def lut_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                   codebook: torch.Tensor, scale: torch.Tensor, *,
                   block_k: int = 128) -> torch.Tensor:
    """Y = X @ (codebook[idx] * scale), correctly rounded."""
    return lut_matmul_fused_ref(x, packed, codebook, scale, block_k=block_k)


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    return x if x.shape == shape else x.sum_to_size(shape)


def matmul_grads(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                 dtype: torch.dtype, needs=(True, True)):
    """(grad a, grad b) of ``a @ b`` for the output gradient ``g``, summed
    in ``dtype`` and rounded to each operand's dtype; a broadcast operand's
    gradient is summed over the axes it was broadcast along."""
    g = g.to(dtype)
    ga = gb = None
    if needs[0]:
        ga = _sum_to(g @ b.to(dtype).mT, a.shape).to(a.dtype)
    if needs[1]:
        if b.ndim == 2:       # fold a's leading axes into one product
            gb = (a.to(dtype).reshape(-1, a.shape[-1]).mT
                  @ g.reshape(-1, g.shape[-1]))
        else:
            gb = _sum_to(a.to(dtype).mT @ g, b.shape)
        gb = gb.to(b.dtype)
    return ga, gb


class _ExactMatmul(torch.autograd.Function):
    """`exact_matmul` under autograd: the backward reads the operands as
    given (float32 or bfloat16), never float64 copies of them, and sums in
    float64, rounded once: the gradient autograd takes through the float64
    product, without keeping that product's operands."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return (a.double() @ b.double()).float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return matmul_grads(a, b, g, torch.float64, ctx.needs_input_grad)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a @ b``, correctly rounded: the float32 products are exact
    in float64 and summed there (error ~K * 2^-53), then rounded once, as the
    CUDA kernel does. Two such implementations agree bit for bit whatever
    order they sum in (unless an exact sum lies within ~K * 2^-53 of a
    float32 rounding midpoint), so the int8 activation quantization that
    follows every layer cannot drift apart between them; see the kernel
    source's header. Under autograd the float64 copies of the operands are
    not kept (`_ExactMatmul`)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _ExactMatmul.apply(a, b)
    return (a.double() @ b.double()).float()


def lut_matmul_fused_ref(x: torch.Tensor, packed: torch.Tensor,
                         codebook: torch.Tensor, scale: torch.Tensor, *,
                         bias: Optional[torch.Tensor] = None,
                         residual: Optional[torch.Tensor] = None,
                         activation: str = "none",
                         block_k: int = 128) -> torch.Tensor:
    """Y = act(X @ dequant(packed) + bias) + residual.

    ``x`` is (M, K_x) with K_x up to K_pad = 2 * packed rows: it multiplies
    the first K_x weight rows (`weight_rows`), so an unpadded X gives the
    padded call's result bit for bit (the padding adds exact zeros). The
    product is `exact_matmul` (float64 accumulation, one rounding to
    float32), as in the kernel; the epilogue is float32 in the kernel's
    order: bias before activation, residual after. The output is float32
    (x is float32 or bfloat16, widened as in the JAX package).
    """
    w = dequantize(packed, codebook, scale, block_k)
    y = exact_matmul(x.float(), weight_rows(w, x.shape[1]))
    if bias is not None:
        y = y + bias.float()[None, :]
    y = ACTIVATIONS[activation](y)
    if residual is not None:
        y = y + residual.float()
    return y
