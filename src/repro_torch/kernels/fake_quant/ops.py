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
MAX_CANDIDATES = 256   # candidates a grouped launch takes (8 bits an entry)
_MASK_DTYPES = (torch.float32, torch.int8)


def _check_scalar(name, v, lo, hi, device, ndims=(0,)) -> None:
    """k / msr_bits: an int, or an int32 tensor of one of ``ndims`` dims (0;
    1 for one value a candidate) on ``device``. Its values are checked where
    they are on the host; a CUDA tensor is not read back (that would
    synchronise every launch), and the kernel computes the plain version's
    function for any value."""
    if isinstance(v, torch.Tensor):
        if v.ndim not in ndims or v.dtype != torch.int32:
            raise ValueError(f"{name} must be an int or a 0-d int32 tensor, "
                             f"got {v.dtype} of shape {tuple(v.shape)}")
        if v.device != device:
            raise ValueError(f"{name} is on {v.device}, w on {device}")
        if v.device.type == "cuda":
            return
        vals = (int(v.min()), int(v.max()))
    elif not isinstance(v, numbers.Integral) or isinstance(v, bool):
        raise ValueError(f"{name} must be an int or a 0-d int32 tensor, "
                         f"got {type(v).__name__}")
    else:
        vals = (int(v),)
    for x in vals:
        if not lo <= x <= hi:
            raise ValueError(f"{name}={x} not in [{lo}, {hi}]")


def _check_layer(w, mask, codebook, k, msr_bits, ndims=(0,)) -> None:
    """What both kernels need of a layer: float32 ``w``, a float32 or int8
    ``mask`` of ``w``'s shape, a (32,) int32 codebook, all contiguous on
    ``w``'s device, and valid ``k`` / ``msr_bits`` (of one of ``ndims``
    dims: 1 where they carry one value a candidate)."""
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
    _check_scalar("k", k, 0, qat.K_MAX, dev, ndims)
    _check_scalar("msr_bits", msr_bits, 0, MAX_MSR_BITS, dev, ndims)


def candidate_leaf(name, t, ndim, n):
    """(candidate 0's view, shared) of a leaf under a candidate axis of
    ``n``: a leaf of ``ndim`` dims (or an int) is shared by every candidate;
    one of ``ndim + 1`` dims has a leading axis of ``n``, shared when its
    stride there is 0 (a `qat.broadcast_pytree` view), else one contiguous
    slice a candidate. Raises `ValueError` on any other layout."""
    if not isinstance(t, torch.Tensor) or t.ndim == ndim:
        return t, True
    if t.ndim != ndim + 1 or t.shape[0] != n:
        raise ValueError(f"{name} must have a leading candidate axis of {n} "
                         f"or none, got shape {tuple(t.shape)}")
    if t.stride(0) == 0:
        return t[0], True
    if n > 1 and t.stride(0) != t[0].numel():
        raise ValueError(f"{name}'s candidates must be contiguous slices or "
                         f"shared (stride 0), got candidate stride "
                         f"{t.stride(0)} for slices of {t[0].numel()}")
    return t[0], False


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


def entry_cands(cands, n: int) -> list:
    """``cands`` of a grouped call as one value an entry: None (no
    candidate axis) or an int for every entry, or a sequence of ``n`` such
    values, one an entry (an LM's stacked units take their layer count, its
    expert units layers x experts)."""
    if cands is None or isinstance(cands, numbers.Integral):
        return [cands] * n
    cands = list(cands)
    if len(cands) != n:
        raise ValueError(f"{n} weights but {len(cands)} candidate counts")
    return cands


def check_group(ws, comps, cands=None) -> None:
    """Raise `ValueError` on anything the grouped kernel does not take,
    naming the entry: an empty group, a count of comps that differs from
    the weights', weights on more than one device, a weight with no element
    or no output axis, and every check of `_check_layer`. With ``cands=n``
    every weight has a leading candidate axis of ``n`` (contiguous slices,
    or stride 0 for one weight shared by all) and every comp leaf either
    the same axis or none (`candidate_leaf`); the checks of `_check_layer`
    then apply to one candidate's slices. ``cands`` may also give one count
    (or None) an entry (`entry_cands`)."""
    if not len(ws):
        raise ValueError("empty group: no weights to fake-quantize")
    if len(comps) != len(ws):
        raise ValueError(f"{len(ws)} weights but {len(comps)} comp states")
    per_entry = entry_cands(cands, len(ws))
    for n in per_entry:
        if n is not None and (isinstance(n, bool)
                              or not isinstance(n, numbers.Integral)
                              or not 1 <= n <= MAX_CANDIDATES):
            raise ValueError(f"cands must be an int in [1, "
                             f"{MAX_CANDIDATES}], got {n!r}")
    dev = ws[0].device
    for i, (w, comp, n) in enumerate(zip(ws, comps, per_entry)):
        try:
            if w.device != dev:
                raise ValueError(f"w is on {w.device}, the group's first "
                                 f"weight on {dev} (one device a group)")
            mask, codebook = comp["mask"], comp["codebook"]
            k, msr = comp["codebook_k"], comp.get("msr_bits", 0)
            ndims = (0,)
            if n is not None:
                if w.ndim < 2:
                    raise ValueError(f"w must have a leading candidate axis "
                                     f"of {n} and an output axis, got "
                                     f"shape {tuple(w.shape)}")
                w, _ = candidate_leaf("w", w, w.ndim - 1, n)
                mask, _ = candidate_leaf("mask", mask, w.ndim, n)
                codebook, _ = candidate_leaf("codebook", codebook, 1, n)
                candidate_leaf("k", k, 0, n)
                candidate_leaf("msr_bits", msr, 0, n)
                ndims = (0, 1)
            if w.ndim < 1 or w.numel() == 0:
                raise ValueError(f"w must have an output axis and elements, "
                                 f"got shape {tuple(w.shape)}")
            _check_layer(w, mask, codebook, k, msr, ndims)
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
    ``g_i * mask_i`` to each ``w_i`` (per candidate under a candidate axis;
    a shared mask broadcasts) and nothing to the comp states (the gradient
    of ``w * mask`` through ``wm + stop_gradient(wq - wm)``; plain array
    code in the JAX package too)."""

    @staticmethod
    def forward(ctx, comps, cands, *ws):
        ctx.save_for_backward(*(c["mask"] for c in comps))
        if ws[0].device.type == "cuda":
            return tuple(_kernel.launch_group(ws, comps, cands))
        return tuple(ref.fake_quant_group_ref(ws, comps, cands))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *(g * m.to(g.dtype)
                              for g, m in zip(gs, ctx.saved_tensors)))


def fake_quant_group(ws, comps, cands=None) -> list:
    """Fake-quantize several layers at once: ``ws[i]`` float32 of any shape
    (the last axis is the output channel), ``comps[i]`` its `qat.CompState`
    (``msr_bits`` optional). Returns ``wm + (wq - wm)`` for each, the value
    of `qat.fake_quant_weight`, with the straight-through gradient
    ``g * mask``. ``cands=n``: each ``ws[i]`` is ``(n, *shape)``, n
    candidates of the layer, and each comp leaf carries the same leading
    axis or is shared (`check_group`); output ``i`` is ``(n, *shape)``,
    candidate ``j`` the value for ``ws[i][j]`` under candidate ``j``'s comp
    (`ref.candidate_comp`); a sequence gives each entry its own ``n`` or
    None (`entry_cands`). Every entry is checked before the dispatch;
    CUDA tensors take one kernel launch (up to the kernel's table of
    layers), CPU tensors the plain version."""
    check_group(ws, comps, cands)
    if ws[0].device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {ws[0].device}")
    return list(_SteFakeQuantGroup.apply(list(comps),
                                         entry_cands(cands, len(ws)), *ws))
