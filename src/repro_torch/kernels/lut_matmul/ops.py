"""Weight encode/pack utilities and the device dispatch of the LUT GEMM.

Port of `repro.kernels.lut_matmul.ops`. `lut_matmul_fused` dispatches by the
device of its tensors: CPU tensors take the plain version (`ref.py`), CUDA
tensors launch the hand-written kernel (`lut_matmul.py`) or raise. The
kernel's configuration (`lut_matmul.K2Config`, the JAX wrapper's
``block_*`` knobs) is the caller's ``config`` or, when None, what the
process-wide tuner resolves (`repro_torch.kernels.lut_matmul.autotune`),
before the dispatch, so the CPU path reaches the tuner's cache too (the
plain version ignores the configuration). The ``interpret`` / ``use_ref``
knobs have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import qat
from repro_torch.kernels.lut_matmul import autotune
from repro_torch.kernels.lut_matmul import lut_matmul as _kernel
from repro_torch.kernels.lut_matmul.ref import N_CODES, lut_matmul_fused_ref


def encode_weights(w_int: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Map int8-valued weights to nearest-codebook indices.

    w_int: (K, N) int weights; codebook: (16,) sorted int values. Returns
    (K, N) int32 indices. Ties (including duplicate/padded codebook entries)
    resolve to the lowest index (`torch.argmin` returns the first minimum).
    """
    dist = (w_int[..., None].to(torch.int32)
            - codebook[None, None, :].to(torch.int32)).abs()
    return torch.argmin(dist, dim=-1).to(torch.int32)


def pack_indices(idx: torch.Tensor, block_k: int = 128) -> torch.Tensor:
    """(K, N) 4-bit indices -> (K//2, N) int8, block-local pairing.

    Within each K block of ``block_k`` rows, byte row j packs index rows j
    (low nibble) and j + block_k/2 (high nibble).
    """
    k, n = idx.shape
    if block_k % 2 != 0:
        raise ValueError(f"block_k must be even, got {block_k}")
    if k % block_k != 0:
        raise ValueError(
            f"K={k} is not a multiple of block_k={block_k}; pad the index "
            "rows first (packing is block-local, see repro_torch.core.export)")
    blocks = idx.reshape(k // block_k, block_k, n).to(torch.int32)
    low = blocks[:, : block_k // 2]
    high = blocks[:, block_k // 2:]
    packed = (low & 0xF) | ((high & 0xF) << 4)
    # values are in [0, 255]: wrap to int8 two's complement like astype(int8)
    return packed.reshape(k // 2, n).to(torch.uint8).view(torch.int8)


def lut_matmul_fused(x: torch.Tensor, packed: torch.Tensor,
                     codebook: torch.Tensor, scale: torch.Tensor, *,
                     bias: Optional[torch.Tensor] = None,
                     residual: Optional[torch.Tensor] = None,
                     activation: str = "none",
                     pack_block: int = 128,
                     config: Optional[_kernel.K2Config] = None
                     ) -> torch.Tensor:
    """Fused serve matmul: Y = act(X @ dequant(packed) + bias) + residual.

    x (M, K_x) float32/bfloat16 with K_x a multiple of 8 and at most K_pad
    (columns past K_x count as zero; the serve path passes K rounded up to
    8); packed (K_pad//2, N) int8 with K_pad a ``pack_block`` multiple;
    codebook (16,) int8; scale/bias (N,) float32; residual (M, N) float32.
    All contiguous, all on one device. ``config``: the kernel's
    configuration; None resolves through `autotune.get_default_autotuner`
    (every configuration gives the same output bit for bit).
    Returns float32 (M, N). CPU tensors run the plain version; CUDA tensors
    launch the kernel in that configuration (a failed launch raises; no
    other configuration is tried).
    """
    _kernel.check_inputs(x, packed, codebook, scale, bias, residual,
                         activation, pack_block)
    if config is None:
        config = autotune.get_default_autotuner().best(
            x.shape[0], x.shape[1], 2 * packed.shape[0], packed.shape[1],
            pack_block=pack_block, x_dtype=x.dtype, device=x.device)
    if x.device.type == "cuda":
        return _kernel.launch(x, packed, codebook, scale, bias=bias,
                              residual=residual, activation=activation,
                              pack_block=pack_block, config=config)
    if x.device.type == "cpu":
        return lut_matmul_fused_ref(x, packed, codebook, scale, bias=bias,
                                    residual=residual, activation=activation,
                                    block_k=pack_block)
    raise ValueError(f"unsupported device {x.device}")


def lut_matmul(x: torch.Tensor, packed: torch.Tensor, codebook: torch.Tensor,
               scale: torch.Tensor, *, block_k: int = 128) -> torch.Tensor:
    """Epilogue-free LUT GEMM (pack block == ``block_k``)."""
    return lut_matmul_fused(x, packed, codebook, scale, pack_block=block_k)


def compress_layer_weights(w: torch.Tensor, codebook_values, *,
                           mask: Optional[torch.Tensor] = None,
                           scale: Optional[torch.Tensor] = None,
                           msr_bits: int = 0, block_k: int = 128,
                           pad_k: bool = False):
    """End-to-end encode of a float (K, N) weight matrix for serving.

    Returns (packed, codebook int8 (16,), scale (N,)): mask -> per-channel
    scale of the *masked* weight (unless ``scale`` is given) -> round/clip ->
    MSR truncation -> nearest-codebook projection, the order of
    `qat.fake_quant_weight`. A pruning ``mask`` is honored exactly: 0 is
    force-included in the serving codebook when the mask prunes anything,
    and pruned positions encode to the index of 0. ``pad_k`` pads K up to a
    ``block_k`` multiple with the 0-nearest index.
    """
    vals = sorted({int(v) for v in codebook_values})
    if not vals:
        raise ValueError("empty codebook")
    prunes = mask is not None and bool((mask == 0).any())
    serve_vals = sorted(set(vals) | {0}) if prunes else vals
    if len(serve_vals) > N_CODES:
        raise ValueError(
            f"codebook needs {len(serve_vals)} entries (> {N_CODES}); "
            "pruned layers must leave room for the forced 0 entry")

    wm = w * mask.to(w.dtype) if mask is not None else w
    if scale is None:
        scale = qat.weight_scale(wm)[0]                 # (N,)
    q = torch.clamp(torch.round(wm / scale[None, :]), -qat.QMAX, qat.QMAX)
    qi = q.to(torch.int32)
    if msr_bits:
        qi = qat.msr_truncate_int(qi, msr_bits)
    cb_train, k_train = qat.make_codebook(vals, device=w.device)
    qp = qat.project_to_codebook(qi, cb_train, k_train)
    if mask is not None:
        qp = torch.where(mask == 0, torch.zeros_like(qp), qp)

    cb = torch.tensor(serve_vals + [serve_vals[-1]] * (N_CODES - len(serve_vals)),
                      dtype=torch.int32, device=w.device)
    idx = encode_weights(qp, cb)
    if pad_k:
        pad = (-idx.shape[0]) % block_k
        if pad:
            zero_idx = int(torch.argmin(cb.abs()))
            idx = torch.cat([idx, idx.new_full((pad, idx.shape[1]), zero_idx)])
    packed = pack_indices(idx, block_k)
    return packed, cb.to(torch.int8), scale
