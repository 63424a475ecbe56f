"""Input checks, device dispatch and straight-through estimator of the fused
weight fake-quant (K3).

Port of `repro.kernels.fake_quant.ops`. `fake_quant_project` dispatches by
the device of its tensors: CPU tensors take the plain version (`ref.py`),
CUDA tensors launch the hand-written kernel (`fake_quant.py`) or raise. The
kernel takes any (M, N) and masks its own ragged edge, so the JAX wrapper's
padding and ``block_*`` / ``interpret`` knobs have no counterpart.
"""

from __future__ import annotations

import numbers

import torch

from repro_torch.core import qat
from repro_torch.kernels.fake_quant import fake_quant as _kernel
from repro_torch.kernels.fake_quant.ref import fake_quant_ref

MAX_MSR_BITS = 8


def _check_scalar(name, v, lo, hi, device) -> None:
    """k / msr_bits: an int, or a 0-d int32 tensor on ``device``. Its value
    is checked where it is on the host; a CUDA scalar is not read back (that
    would synchronise every launch), and the kernel computes the plain
    version's function for any value."""
    if isinstance(v, torch.Tensor):
        if v.ndim != 0 or v.dtype != torch.int32:
            raise ValueError(f"{name} must be an int or a 0-d int32 tensor, "
                             f"got {v.dtype} of shape {tuple(v.shape)}")
        if v.device != device:
            raise ValueError(f"{name} is on {v.device}, w on {device}")
        if v.device.type == "cuda":
            return
        v = int(v)
    elif not isinstance(v, numbers.Integral) or isinstance(v, bool):
        raise ValueError(f"{name} must be an int or a 0-d int32 tensor, "
                         f"got {type(v).__name__}")
    if not lo <= v <= hi:
        raise ValueError(f"{name}={v} not in [{lo}, {hi}]")


def check_inputs(w, mask, scale, codebook, k, msr_bits) -> None:
    """Raise `ValueError` on anything the kernel does not take: shapes,
    dtypes, devices, contiguity (the kernel reads raw row-major memory, so
    a strided view is refused rather than copied behind the caller's back),
    ``k`` in [0, 32] and ``msr_bits`` in [0, 8]."""
    if w.ndim != 2:
        raise ValueError(f"w must be 2-D (M, N), got {tuple(w.shape)}")
    m, n = w.shape
    if w.dtype != torch.float32:
        raise ValueError(f"w must be float32, got {w.dtype}")
    if mask.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"mask must be float32 or int8, got {mask.dtype}")
    want = {"mask": (mask, (m, n)), "scale": (scale, (n,)),
            "codebook": (codebook, (qat.K_MAX,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if codebook.dtype != torch.int32:
        raise ValueError(f"codebook must be int32, got {codebook.dtype}")
    for name, t in (("w", w), ("mask", mask), ("scale", scale),
                    ("codebook", codebook)):
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous row-major; build it "
                             "contiguous (no strided views)")
    _check_scalar("k", k, 0, qat.K_MAX, w.device)
    _check_scalar("msr_bits", msr_bits, 0, MAX_MSR_BITS, w.device)


def fake_quant_project(w: torch.Tensor, mask: torch.Tensor,
                       scale: torch.Tensor, codebook: torch.Tensor, k,
                       msr_bits=0) -> torch.Tensor:
    """Fused ``w * mask`` -> int8 quantize with the per-column ``scale`` ->
    MSR truncation -> projection onto the first ``k`` codebook values ->
    dequantize. w (M, N) float32, mask (M, N) float32/int8, scale (N,)
    float32, codebook (32,) int32, k and msr_bits ints or 0-d int32 tensors.
    Returns float32 (M, N). CPU tensors run the plain version; CUDA tensors
    launch the kernel. No gradient: see `ste_fake_quant`."""
    check_inputs(w, mask, scale, codebook, k, msr_bits)
    if w.device.type == "cuda":
        return _kernel.launch(w, mask, scale, codebook, k, msr_bits)
    if w.device.type == "cpu":
        return fake_quant_ref(w, mask, scale, codebook, k, msr_bits)
    raise ValueError(f"unsupported device {w.device}")


class _SteFakeQuant(torch.autograd.Function):
    """Forward `fake_quant_project`; straight-through backward ``g * mask``
    to ``w`` and nothing to the other inputs (the JAX package's custom
    VJP, whose backward is plain array code, not a kernel)."""

    @staticmethod
    def forward(ctx, w, mask, scale, codebook, k, msr_bits):
        ctx.save_for_backward(mask)
        return fake_quant_project(w, mask, scale, codebook, k, msr_bits)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask.to(g.dtype), None, None, None, None, None


def ste_fake_quant(w: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                   codebook: torch.Tensor, k, msr_bits=0) -> torch.Tensor:
    """`fake_quant_project` with the straight-through gradient ``g * mask``
    with respect to ``w``."""
    return _SteFakeQuant.apply(w, mask, scale, codebook, k, msr_bits)
