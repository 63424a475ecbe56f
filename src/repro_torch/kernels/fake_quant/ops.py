"""Input checks, device dispatch and straight-through estimator of the fused
weight fake-quant (K3).

Port of `repro.kernels.fake_quant.ops`. `fake_quant_project` (one layer,
the caller's scale) and `fake_quant_group` (a QAT forward's layers, scale
and straight-through value inside) dispatch by the device of their tensors:
CPU tensors take the plain version (`ref.py`), CUDA tensors launch the
hand-written kernel (`fake_quant.py`) or raise. The kernels take any (M, N)
and mask their own ragged edge, so the JAX wrapper's padding and
``block_*`` / ``interpret`` knobs have no counterpart.
"""

from __future__ import annotations

import numbers

import torch

from repro_torch.core import qat
from repro_torch.kernels.fake_quant import fake_quant as _kernel
from repro_torch.kernels.fake_quant import ref  # module: qat imports ops

MAX_MSR_BITS = 8
_MASK_DTYPES = (torch.float32, torch.int8)


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


def _check_layer(w, mask, codebook, k, msr_bits) -> None:
    """What both kernels need of a layer: float32 ``w``, a float32 or int8
    ``mask`` of ``w``'s shape, a (32,) int32 codebook, all contiguous on
    ``w``'s device, and valid ``k`` / ``msr_bits``."""
    if w.dtype != torch.float32:
        raise ValueError(f"w must be float32, got {w.dtype}")
    if mask.dtype not in _MASK_DTYPES:
        raise ValueError(f"mask must be float32 or int8, got {mask.dtype}")
    if mask.shape != w.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != "
                         f"{tuple(w.shape)}")
    if codebook.shape != (qat.K_MAX,):
        raise ValueError(f"codebook shape {tuple(codebook.shape)} != "
                         f"({qat.K_MAX},)")
    if codebook.dtype != torch.int32:
        raise ValueError(f"codebook must be int32, got {codebook.dtype}")
    dev = w.device
    for name, t in (("w", w), ("mask", mask), ("codebook", codebook)):
        if t is not w and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, w on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous row-major; build it "
                             "contiguous (no strided views)")
    _check_scalar("k", k, 0, qat.K_MAX, dev)
    _check_scalar("msr_bits", msr_bits, 0, MAX_MSR_BITS, dev)


def check_inputs(w, mask, scale, codebook, k, msr_bits) -> None:
    """Raise `ValueError` on anything the per-layer kernel does not take:
    shapes, dtypes, devices, contiguity (the kernel reads raw row-major
    memory, so a strided view is refused rather than copied behind the
    caller's back), ``k`` in [0, 32] and ``msr_bits`` in [0, 8]."""
    if w.ndim != 2:
        raise ValueError(f"w must be 2-D (M, N), got {tuple(w.shape)}")
    if tuple(scale.shape) != (w.shape[1],):
        raise ValueError(f"scale shape {tuple(scale.shape)} != "
                         f"({w.shape[1]},)")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if scale.device != w.device:
        raise ValueError(f"scale is on {scale.device}, w on {w.device}")
    if not scale.is_contiguous():
        raise ValueError("scale must be contiguous")
    _check_layer(w, mask, codebook, k, msr_bits)


def check_group(ws, comps) -> None:
    """Raise `ValueError` on anything the grouped kernel does not take,
    naming the entry: an empty group, a count of comps that differs from
    the weights', weights on more than one device, a weight with no element
    or no output axis, and every check of `_check_layer`."""
    if not len(ws):
        raise ValueError("empty group: no weights to fake-quantize")
    if len(comps) != len(ws):
        raise ValueError(f"{len(ws)} weights but {len(comps)} comp states")
    dev = ws[0].device
    for i, (w, comp) in enumerate(zip(ws, comps)):
        try:
            if w.device != dev:
                raise ValueError(f"w is on {w.device}, the group's first "
                                 f"weight on {dev} (one device a group)")
            if w.ndim < 1 or w.numel() == 0:
                raise ValueError(f"w must have an output axis and elements, "
                                 f"got shape {tuple(w.shape)}")
            _check_layer(w, comp["mask"], comp["codebook"],
                         comp["codebook_k"], comp.get("msr_bits", 0))
        except ValueError as e:
            raise ValueError(f"group entry {i}: {e}") from None


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
        return ref.fake_quant_ref(w, mask, scale, codebook, k, msr_bits)
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


class _SteFakeQuantGroup(torch.autograd.Function):
    """Forward: every layer's straight-through value, one grouped kernel
    launch for CUDA tensors, the plain version for CPU tensors. Backward:
    ``g_i * mask_i`` to each ``w_i`` and nothing to the comp states (the
    gradient of ``w * mask`` through ``wm + stop_gradient(wq - wm)``; plain
    array code in the JAX package too)."""

    @staticmethod
    def forward(ctx, comps, *ws):
        ctx.save_for_backward(*(c["mask"] for c in comps))
        if ws[0].device.type == "cuda":
            return tuple(_kernel.launch_group(ws, comps))
        return tuple(ref.fake_quant_ste_ref(w, c) for w, c in zip(ws, comps))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *(g * m.to(g.dtype)
                        for g, m in zip(gs, ctx.saved_tensors)))


def fake_quant_group(ws, comps) -> list:
    """Fake-quantize several layers at once: ``ws[i]`` float32 of any shape
    (the last axis is the output channel), ``comps[i]`` its `qat.CompState`
    (``msr_bits`` optional). Returns ``wm + (wq - wm)`` for each, the value
    of `qat.fake_quant_weight`, with the straight-through gradient
    ``g * mask``. Every entry is checked before the dispatch; CUDA tensors
    take one kernel launch, CPU tensors the plain version."""
    check_group(ws, comps)
    if ws[0].device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {ws[0].device}")
    return list(_SteFakeQuantGroup.apply(list(comps), *ws))
