"""Quantization-aware training primitives with weight-set restriction.

Port of `repro.core.qat` (paper 4.2): int8 symmetric fake-quantization with
a straight-through estimator, magnitude pruning masks, most-significant-run
(MSR) truncation, and projection onto a per-layer codebook ``C_l`` of allowed
int8 values. Every function computes the same values as its JAX counterpart
on the same inputs (bit for bit on the CPU).

The compression state of a layer is a plain dict of tensors:

    comp = {
      "mask":       float tensor, same shape as w (all-ones = no pruning)
      "codebook":   (K_MAX,) int32 sorted allowed values (padded by repeats)
      "codebook_k": () int32, number of valid entries; 0 = unrestricted
      "msr_bits":   () int32, MSR truncation depth; 0 = off
    }

Weight layout convention: the *last* axis of a weight tensor is the output
channel; quantization scales are per-output-channel over all other axes.

`fake_quant_weight` runs its mask / quantize / MSR / projection chain
through the fused kernel K3 (`repro_torch.kernels.fake_quant`): the plain
version for CPU tensors, the CUDA kernel for CUDA tensors.
`fake_quant_weights` does the same for a whole forward's layers in one
grouped K3 launch, the per-column scale and the straight-through value
included, and with ``cands=n`` for n stacked candidates of every layer in
that same one launch.

The schedule's batched candidate sweep stacks n per-candidate trees (comp
dicts, params, state, optimizer state) along a new leading *candidate*
axis: `stack_pytrees`, `broadcast_pytree` (a stride-0 view: every candidate
shares the one tensor, which the grouped kernel reads once), `index_pytree`
and `pad_leading`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import tree_map
from repro_torch.distributed.sharding import batch_reduce
from repro_torch.kernels.fake_quant import ops as fake_quant_ops

K_MAX = 32          # maximum codebook size the pipeline ever uses (paper: 32)
QMAX = 127          # symmetric int8 range [-127, 127]

CompState = Dict[str, torch.Tensor]


def identity_comp(w_shape: Tuple[int, ...], dtype=torch.float32, *,
                  device) -> CompState:
    """No-op compression state (no pruning, no restriction)."""
    return {
        "mask": torch.ones(w_shape, dtype=dtype, device=device),
        "codebook": torch.zeros((K_MAX,), dtype=torch.int32, device=device),
        "codebook_k": torch.zeros((), dtype=torch.int32, device=device),
        "msr_bits": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_codebook(values, *, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build a padded sorted codebook from a list of int values."""
    vals = sorted(int(v) for v in values)
    k = len(vals)
    if k == 0:
        return (torch.zeros((K_MAX,), dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
    if k > K_MAX:
        raise ValueError(f"codebook size {k} exceeds K_MAX={K_MAX}")
    padded = vals + [vals[-1]] * (K_MAX - k)
    return (torch.tensor(padded, dtype=torch.int32, device=device),
            torch.tensor(k, dtype=torch.int32, device=device))


def make_codebooks(value_sets, *, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Batched `make_codebook`: (E, K_MAX) sorted padded codebooks and (E,)
    valid counts, built on the host and moved as two tensors (the lockstep
    elimination scores dozens of trial codebooks a round)."""
    cbs = np.zeros((len(value_sets), K_MAX), np.int32)
    ks = np.zeros((len(value_sets),), np.int32)
    for e, values in enumerate(value_sets):
        vals = sorted(int(v) for v in values)
        k = len(vals)
        if k > K_MAX:
            raise ValueError(f"codebook size {k} exceeds K_MAX={K_MAX}")
        ks[e] = k
        if k:
            cbs[e, :k] = vals
            cbs[e, k:] = vals[-1]
    return (torch.from_numpy(cbs).to(device),
            torch.from_numpy(ks).to(device))


def _over_qmax(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / QMAX`` as a true division. On CUDA, PyTorch turns
    division by a Python scalar into multiplication by its reciprocal, which
    can differ in the last bit; dividing by a device tensor keeps scales
    bit-identical to the CPU and to the JAX package."""
    return torch.clamp(amax, min=1e-8) / amax.new_full((), QMAX)


def weight_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scale, broadcastable against ``w``."""
    if w.ndim <= 1:                 # no axis to reduce: the scale is |w| itself
        amax = w.abs()
    else:
        amax = torch.amax(w.abs(), dim=tuple(range(w.ndim - 1)), keepdim=True)
    return _over_qmax(amax)


def project_to_codebook(q: torch.Tensor, codebook: torch.Tensor,
                        k) -> torch.Tensor:
    """Map integer weights to the nearest of the first ``k`` codebook values.

    ``q`` int32 in [-128, 127], ``codebook`` (K_MAX,) int32 sorted. ``k == 0``
    means unrestricted (identity). Ties break toward the smaller value: the
    nearest-member map is resolved once for all 256 int8 values and `argmin`
    returns the first (lowest-index, smallest-value) minimum.
    """
    k = torch.as_tensor(k, dtype=torch.int32, device=codebook.device)
    valid = torch.arange(K_MAX, device=codebook.device) < torch.clamp(k, min=1)
    vals = torch.arange(-128, 128, dtype=torch.int32, device=codebook.device)
    dist = (vals[:, None] - codebook[None, :]).abs()
    dist = torch.where(valid, dist, torch.full_like(dist, 1 << 20))
    proj_lut = codebook[torch.argmin(dist, dim=-1)]     # (256,)
    projected = proj_lut[(q + 128).long()]
    return torch.where(k > 0, projected, q)


def _bit_length(mag: torch.Tensor) -> torch.Tensor:
    """1-based index of the most significant set bit of non-negative int32
    values, 0 for 0 (``32 - clz``; torch has no clz)."""
    out = torch.zeros_like(mag)
    for b in range(31):
        out += (mag >= (1 << b)).to(mag.dtype)
    return out


def msr_truncate_int(q: torch.Tensor, bits) -> torch.Tensor:
    """Most-significant-run truncation of integer weights.

    Keeps the top ``bits`` significant bits of ``|q|`` and zeroes the rest,
    preserving sign; ``bits == 0`` is the identity.
    """
    bits = torch.as_tensor(bits, dtype=torch.int32, device=q.device)
    mag = q.abs()
    shift = torch.clamp(_bit_length(mag) - bits, min=0)
    trunc = torch.sign(q) * ((mag >> shift) << shift)
    return torch.where(bits > 0, trunc, q)


def _round_clip(v: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(v), -QMAX, QMAX)


def clipped_to_int(q: torch.Tensor) -> torch.Tensor:
    """int32 of `_round_clip`'s output, a NaN (from a NaN weight or scale)
    taken as 0, as the JAX package's float-to-int conversion takes it, so it
    indexes the codebook table in range."""
    return torch.nan_to_num(q, nan=0.0).to(torch.int32)


def quantize_weight_int(w: torch.Tensor,
                        comp: Optional[CompState] = None) -> torch.Tensor:
    """Integer (int32-valued int8) view of a weight tensor after mask / quant
    / MSR truncation / projection."""
    if comp is not None:
        w = w * comp["mask"].to(w.dtype)
    scale = weight_scale(w)
    q = clipped_to_int(_round_clip(w / scale))
    if comp is not None:
        msr = comp.get("msr_bits")
        if msr is not None:
            q = msr_truncate_int(q, msr)
        q = project_to_codebook(q, comp["codebook"], comp["codebook_k"])
    return q


def fake_quant_weight(w: torch.Tensor,
                      comp: Optional[CompState] = None) -> torch.Tensor:
    """Fake-quantized (float) weights with a straight-through estimator;
    applies mask + optional MSR truncation + codebook.

    The chain runs through K3 on the weight viewed as ``(-1, C_out)``, with
    the per-output-channel scale of the masked weight computed here (the
    kernel's contract) and ``k`` / ``msr_bits`` left on the device. The
    result is the JAX package's ``wm + stop_gradient(wq - wm)``: its forward
    equals the JAX package bit for bit, and its gradient with respect to
    ``w`` is the mask."""
    if comp is None:
        comp = identity_comp(tuple(w.shape), w.dtype, device=w.device)
    wm = w * comp["mask"].to(w.dtype)
    n = w.shape[-1]
    msr = comp.get("msr_bits")
    wq = fake_quant_ops.fake_quant_project(
        w.detach().reshape(-1, n), comp["mask"].reshape(-1, n),
        weight_scale(wm.detach()).reshape(-1), comp["codebook"],
        comp["codebook_k"], 0 if msr is None else msr).reshape(w.shape)
    # straight-through: forward value wq, gradient of identity wrt wm
    return wm + (wq - wm).detach()


def fake_quant_weights(ws: Sequence[torch.Tensor],
                       comps: Sequence[Optional[CompState]],
                       cands: Optional[int] = None) -> List[torch.Tensor]:
    """`fake_quant_weight` of several layers at once (``comps[i]`` None =
    identity): one grouped K3 launch for CUDA tensors, the plain version
    for CPU tensors. Each output equals ``fake_quant_weight(ws[i],
    comps[i])`` bit for bit, and so does its gradient (the mask).

    ``cands=n``: every ``ws[i]`` has a leading candidate axis ``(n,
    *shape)`` and each comp leaf either has one too or is shared (see
    `repro_torch.kernels.fake_quant.ops.fake_quant_group`); candidate j of
    output i equals ``fake_quant_weight(ws[i][j], comps[i] at j)``, and all
    n x len(ws) weights still take one launch. The LM's fake-quant forward
    passes its stacked ``(L, ...)`` units this way, the layer axis as the
    candidate axis (`repro_torch.models.lm`): layer j gets the per-slice
    value of the JAX package's scan, its own scale included. ``cands`` a
    sequence: one count (or None) an entry, so stacked units (layers as
    candidates) and expert units (layers x experts) share one launch."""
    per_entry = fake_quant_ops.entry_cands(cands, len(ws))
    comps = [identity_comp(tuple(w.shape[1:] if n else w.shape), w.dtype,
                           device=w.device) if c is None else c
             for w, c, n in zip(ws, comps, per_entry, strict=True)]
    return fake_quant_ops.fake_quant_group(list(ws), comps, cands)


def _act_scale(a: torch.Tensor, cand_dim: Optional[int] = None,
               token_dims: int = 0) -> torch.Tensor:
    if token_dims:
        return _over_qmax(a.abs().amax(dim=tuple(range(token_dims, a.ndim)),
                                       keepdim=True))
    if cand_dim is None:
        amax = a.abs().amax()
        red = batch_reduce()
        if red is not None:             # a meshed step's rows: the global amax
            amax = red.max(amax)
        return _over_qmax(amax)
    dims = [d for d in range(a.ndim) if d != cand_dim % a.ndim]
    return _over_qmax(a.abs().amax(dim=dims, keepdim=True))


def fake_quant_act(a: torch.Tensor, cand_dim: Optional[int] = None, *,
                   token_dims: int = 0) -> torch.Tensor:
    """Dynamic per-tensor symmetric int8 fake-quantization of activations.
    ``cand_dim``: the candidate axis of a batched activation; each
    candidate's slice then gets its own scale (its own amax), the value a
    forward of that candidate alone computes. ``token_dims`` > 0: the first
    ``token_dims`` axes index token positions, and each position gets its
    own scale (the amax over the remaining axes). Inside a meshed step
    whose batch is split over ranks (`repro_torch.distributed.sharding
    .batch_reduction`), the one per-tensor amax is the global batch's (a
    MAX over those ranks), as in the JAX package's sharded step."""
    scale = _act_scale(a, cand_dim, token_dims)
    q = _round_clip(a / scale) * scale
    return a + (q - a).detach()


def quantize_act_int(a: torch.Tensor) -> torch.Tensor:
    """Integer int8 view of activations (for energy-trace profiling)."""
    return _round_clip(a / _act_scale(a)).to(torch.int32)


def magnitude_prune_mask(w: torch.Tensor, ratio: float) -> torch.Tensor:
    """Unstructured magnitude pruning mask keeping the top (1-ratio) weights."""
    if ratio <= 0.0:
        return torch.ones_like(w)
    flat = w.abs().reshape(-1)
    k = int(round(ratio * flat.shape[0]))
    k = min(max(k, 0), flat.shape[0] - 1)
    thresh = torch.sort(flat).values[k]
    return (w.abs() >= thresh).to(w.dtype)


def apply_comp_dtype(comp: CompState, dtype) -> CompState:
    """A copy of ``comp`` with its mask cast to ``dtype``."""
    out = dict(comp)
    out["mask"] = comp["mask"].to(dtype)
    return out


# ----------------------------------------------------------- stacked trees


def stack_pytrees(trees: Sequence):
    """Stack identically structured tensor trees along a new leading
    candidate axis (a copy)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def broadcast_pytree(tree, n: int):
    """Every leaf repeated ``n`` times along a new leading candidate axis,
    as a stride-0 view: nothing is copied, and the grouped K3 launch reads
    such a leaf once for all candidates. Results built from it are new
    tensors; nothing writes through the view."""
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)), tree)


def index_pytree(tree, i: int):
    """Candidate ``i`` of a stacked tree, as tensors of its own."""
    return tree_map(lambda x: x[i].clone(), tree)


def pad_leading(tree, n_to: int):
    """The leading axis padded up to ``n_to`` by repeating its last entry
    (callers discard the padded slots). A stride-0 leaf
    (`broadcast_pytree`) stays a stride-0 view."""
    def one(x):
        pad = n_to - x.shape[0]
        if pad <= 0:
            return x
        if x.stride(0) == 0:
            return x[:1].expand((n_to,) + tuple(x.shape[1:]))
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])

    return tree_map(one, tree)
