"""Griffin/RecurrentGemma RG-LRU recurrent block [arXiv:2402.19427] (port
of `repro.nn.rglru`).

Block structure (the "recurrent" temporal mixer of Griffin):

    x -> linear (d_model -> d_rnn)  -> causal depthwise conv1d -> RG-LRU -> *
    x -> linear (d_model -> d_rnn)  -> GeLU gate -------------------------^
    * -> out projection (d_rnn -> d_model)

RG-LRU recurrence (elementwise over the d_rnn channels):

    r_t = sigmoid(W_a x_t + b_a)                 (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                 (input gate)
    log a_t = -c * softplus(Lambda) * r_t        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training/prefill runs the recurrence as `linear_scan`: the odd/even
recursion of ``jax.lax.associative_scan``, written out for this one
combine, so it takes about log2(S) vectorized steps (not S) and rounds in
the reference's float32 order; it is elementwise over batch and channels,
so a row's result never depends on the rows beside it. Decode is the
single-step update. Gate matrices are full dense (the reference's
documented simplification). The recurrence parameters Lambda are float32
and are not compressible units. While a `repro_torch.core.routing_stats`
collector is set, `apply_rglru` emits the mean square of its float32 input
(the scan target's calibration tap).

**Split over "model"** (``tp``, a meshed step's
`repro_torch.distributed.sharding.ModelSplit`): each model rank runs its
chunk of the d_rnn channels. in_proj and gate_proj are column-parallel,
the conv and the scan per channel; w_a and w_x, stored by rows, take the
rank's chunk of the conv output, so their products are partial sums,
reduce-scattered over the ranks (float64 under QAT, rounded once) into the
rank's chunk of the gates; b_a, b_x and Lambda (replicated) are read at
that chunk; out_proj is row-parallel. The decode cache holds the rank's
channels.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core import routing_stats
from repro_torch.distributed.sharding import copy_to_model
from repro_torch.models.config import RGLRUDims
from repro_torch.nn.layers import QuantConfig, gelu, lm_fake_quant_act
from repro_torch.nn.spec import ParamSpec, fan_in_init, normal_init, zeros_init
from repro_torch.nn.ssm import (
    _causal_depthwise_conv,
    _conv_tail,
    _mixer_input,
    _mm_fn,
    softplus,
)

__all__ = ["RGLRUDims", "apply_rglru", "apply_rglru_decode",
           "init_rglru_cache", "linear_scan", "make_rglru_spec",
           "rglru_cache_spec"]

_C = 8.0


def make_rglru_spec(dims: RGLRUDims, dtype=torch.float32) -> dict:
    d, r = dims.d_model, dims.d_rnn

    def lambda_init(gen, shape, dtype_):
        # sigma(Lambda) in ~(0.9, 0.999): solve exp(-c*softplus(L)) = u^c,
        # softplus(L) = -log(u)
        u = 0.9 + (0.999 - 0.9) * torch.rand(shape, generator=gen)
        return torch.log(torch.expm1(-torch.log(u))).to(dtype_)

    return {
        "in_proj": ParamSpec((d, r), dtype, ("embed", "inner"),
                             fan_in_init(in_axis=0)),
        "gate_proj": ParamSpec((d, r), dtype, ("embed", "inner"),
                               fan_in_init(in_axis=0)),
        "conv_w": ParamSpec((dims.conv_width, r), dtype, (None, "inner"),
                            normal_init(0.1)),
        "conv_b": ParamSpec((r,), dtype, ("inner",), zeros_init),
        "w_a": ParamSpec((r, r), dtype, ("inner", None),
                         fan_in_init(in_axis=0)),
        "b_a": ParamSpec((r,), dtype, (None,), zeros_init),
        "w_x": ParamSpec((r, r), dtype, ("inner", None),
                         fan_in_init(in_axis=0)),
        "b_x": ParamSpec((r,), dtype, (None,), zeros_init),
        "lam": ParamSpec((r,), torch.float32, (None,), lambda_init),
        "out_proj": ParamSpec((r, d), dtype, ("inner", "embed"),
                              fan_in_init(in_axis=0)),
    }


# ------------------------------------------------------------------ the scan


def _combine(left, right):
    (a1, b1), (a2, b2) = left, right
    return a1 * a2, b1 * a2 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even at positions 0, 2, ... and odd at 1, 3, ... along axis 1
    (``even`` may be one longer)."""
    n = even.shape[1] + odd.shape[1]
    if even.shape[1] > odd.shape[1]:
        odd = torch.cat([odd, torch.zeros_like(even[:, :1])], dim=1)
    return torch.stack([even, odd], dim=2).flatten(1, 2)[:, :n]


def _scan(elems: List[torch.Tensor]) -> List[torch.Tensor]:
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _scan(list(reduced))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def linear_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t from h_{-1} = 0 along axis 1 of (B, S,
    ...) tensors: ``jax.lax.associative_scan`` of the combine
    ``(a1 a2, b1 a2 + b2)``, in its recursion order."""
    return _scan([a, bx])[1]


# ------------------------------------------------------------------ the block


def _channels(params, key: str, tp):
    """A replicated per-channel leaf at this rank's channels (through a
    `copy_to_model` copy: the ranks' gradients are summed); whole without
    ``tp``."""
    v = params[key]
    if tp is None:
        return v
    n, start = tp.chunk(v.shape[-1])
    return copy_to_model(v, tp)[..., start:start + n]


def _rglru_coeffs(params, xc, qcfg, comp, name, w_eff, tp=None):
    """Per-step (a, beta*i*x) terms, float32, from conv output xc (B, S,
    r); the gate products take xc's dtype (float32 in decode, where the
    float32 conv history promotes it). ``tp``: xc is this rank's channels,
    and so are the terms."""
    mm = _mm_fn(params, qcfg, comp, name, xc.dtype, w_eff, tp)
    r_gate = torch.sigmoid(mm("w_a", xc)
                           + _channels(params, "b_a", tp).to(xc.dtype))
    i_gate = torch.sigmoid(mm("w_x", xc)
                           + _channels(params, "b_x", tp).to(xc.dtype))
    log_a = -_C * softplus(_channels(params, "lam", tp)) * r_gate.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    bx = beta * (i_gate.float() * xc.float())
    return a, bx


def apply_rglru(params, x: torch.Tensor, dims: RGLRUDims, *,
                qcfg: QuantConfig = QuantConfig.off(), comp=None,
                name: str = "rglru", return_state: bool = False,
                w_eff=None, tp=None):
    """Training/prefill path over x (B, S, d_model). With ``return_state``
    also returns the decode cache ({"h", "conv"}) at the end of the
    sequence. ``w_eff``: {"rglru/in_proj": fake-quantized weight, ...}
    where the model computed them. ``tp``: this rank's channels (module
    docstring); so is the cache."""
    collector = routing_stats.get_collector()
    if collector is not None:
        collector("rglru", name, routing_stats.mean_square(x))
    mm = _mm_fn(params, qcfg, comp, name, x.dtype, w_eff, tp)
    xin = _mixer_input(x, qcfg, tp)
    branch = mm("in_proj", xin)
    gate = mm("gate_proj", xin)

    xc = _causal_depthwise_conv(branch, params["conv_w"].to(x.dtype),
                                params["conv_b"].to(x.dtype))
    a, bx = _rglru_coeffs(params, xc, qcfg, comp, name, w_eff, tp)
    h = linear_scan(a, bx)
    out = h.to(x.dtype) * gelu(gate)
    out = mm("out_proj", lm_fake_quant_act(out, qcfg, tp))
    if return_state:
        return out, {"h": h[:, -1].float(),
                     "conv": _conv_tail(branch, dims.conv_width)}
    return out


def rglru_cache_spec(batch: int, dims: RGLRUDims,
                     dtype=torch.float32) -> dict:
    """{"h", "conv"}: shape-and-dtype placeholders (meta tensors)."""
    return {
        "h": torch.empty((batch, dims.d_rnn), dtype=dtype, device="meta"),
        "conv": torch.empty((batch, dims.conv_width - 1, dims.d_rnn),
                            dtype=dtype, device="meta"),
    }


def init_rglru_cache(batch: int, dims: RGLRUDims, dtype=torch.float32, *,
                     device) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in rglru_cache_spec(batch, dims, dtype).items()}


def apply_rglru_decode(params, x: torch.Tensor, cache: dict,
                       dims: RGLRUDims, *,
                       qcfg: QuantConfig = QuantConfig.off(), comp=None,
                       name: str = "rglru", w_eff=None, tp=None
                       ) -> Tuple[torch.Tensor, dict]:
    """One decode step: x (B, 1, d_model), cache {"h" (B, r), "conv" (B,
    W-1, r)}. The conv history is the cache concatenated with the new
    branch, promoted as ``jnp.concatenate`` promotes (float32 with a
    float32 cache). Returns (output (B, 1, d), new cache). ``tp``: this
    rank's channels, as `apply_rglru`; the cache holds them."""
    mm = _mm_fn(params, qcfg, comp, name, x.dtype, w_eff, tp)
    xin = _mixer_input(x, qcfg, tp)
    branch = mm("in_proj", xin)
    gate = mm("gate_proj", xin)

    hist = torch.cat([cache["conv"], branch], dim=1)          # (B, W, r)
    w = params["conv_w"].to(x.dtype)
    prods = hist.double() * w.double() if qcfg.batch_invariant \
        else hist.float() * w.float()
    dt = torch.promote_types(hist.dtype, w.dtype)             # einsum's
    xc = prods.sum(dim=1).to(dt) + params["conv_b"].to(x.dtype)
    new_conv = hist[:, 1:]

    a, bx = _rglru_coeffs(params, xc[:, None], qcfg, comp, name, w_eff, tp)
    h_new = a[:, 0] * cache["h"].float() + bx[:, 0]
    out = h_new.to(x.dtype)[:, None] * gelu(gate)
    out = mm("out_proj", lm_fake_quant_act(out, qcfg, tp))
    return out, {"h": h_new.to(cache["h"].dtype), "conv": new_conv}
