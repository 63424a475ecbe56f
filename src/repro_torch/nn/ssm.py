"""Mamba-2 SSD (state-space duality) mixer: chunked train/prefill and
decode (port of `repro.nn.ssm`).

Implements the SSD algorithm of Mamba-2 [arXiv:2405.21060]: the sequence is
split into chunks; diagonal (intra-chunk) blocks are computed as masked
attention-like products, inter-chunk information flows through a loop over
per-chunk states. Decode is the O(1) recurrent state update.

The JAX package writes the contractions as ``jnp.einsum`` (a five-operand
one among them); here each is written out as batched products over the
head axis split into (groups, heads a group), so B and C are read once a
group instead of repeated a head. The products and the state carry are
float32, as in the reference. With ``exact`` (the serving engine's
`QuantConfig.batch_invariant`) every product, the chunk-local cumulative
sums sum in float64 and round once, so a row's result does not depend on
how many rows the call holds. The gated RMS norm's mean square is always a
float64 sum rounded once: split over the model ranks, the ranks' partial
sums then give the same bits.

**Split over "model"** (``tp``, a meshed step's
`repro_torch.distributed.sharding.ModelSplit`): each model rank runs its
chunk of the heads. in_proj's stored columns are the concatenation z | x |
B | C | dt, whose contiguous chunks do not line up with heads: a rank
computes its stored chunk (column-parallel, as the JAX partitioner does)
and the chunks are all-gathered (`gather_from_model`, ``summed``: the
backward reduce-scatters the ranks' gradients, in float64 rounded once
under QAT), then each rank takes its
heads' z, x and dt columns and all of B and C (``n_groups`` = 1: every
head reads them). The conv weights are gathered whole and read at the same
channels (`copy_to_model`: their gradient is summed over the ranks); the
per-head scalars, norm_scale and out_proj's rows are the rank's chunk;
the SSD runs on its heads, the gated norm's sum of squares is summed over
the ranks (`model_sum`), and out_proj is row-parallel. The decode cache's
``state`` holds the rank's heads, its ``conv`` every channel (the step
rebuilds the whole history from the gathered projections).

Projections (in/out) are compressible units like every other matmul; the
per-head A/dt/D scalars are not (they never occupy a systolic weight
register) and stay float32 whatever the parameter dtype. While a
`repro_torch.core.routing_stats` collector is set, `apply_ssm` emits the
mean square of its float32 input (the scan target's calibration tap).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import routing_stats
from repro_torch.distributed.sharding import (
    copy_to_model,
    gather_from_model,
    model_sum,
    read_as,
)
from repro_torch.kernels.lut_matmul.ref import exact_matmul
from repro_torch.models.config import SSMDims
from repro_torch.nn.layers import (
    QuantConfig,
    lm_fake_quant_act,
    quantized_mm,
)
from repro_torch.nn.spec import (
    ParamSpec,
    fan_in_init,
    normal_init,
    ones_init,
    zeros_init,
)

__all__ = ["SSMDims", "apply_ssm", "apply_ssm_decode", "init_ssm_cache",
           "make_ssm_spec", "ssd_chunked", "ssm_cache_spec"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's `F.softplus`
    switches to ``x`` above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def make_ssm_spec(dims: SSMDims, dtype=torch.float32) -> dict:
    d, di, h = dims.d_model, dims.d_inner, dims.n_heads
    gn = dims.n_groups * dims.d_state
    in_out = 2 * di + 2 * gn + h  # z, x, B, C, dt

    def a_init(gen, shape, dtype_):
        del gen
        # A in [-16, -1): log-uniform-ish init as in mamba2
        return torch.log(torch.linspace(1.0, 16.0, shape[0])).to(dtype_)

    def dt_bias_init(gen, shape, dtype_):
        del gen
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(0.1),
                                      shape[0]))
        return torch.log(torch.expm1(dt)).to(dtype_)   # inverse softplus

    return {
        "in_proj": ParamSpec((d, in_out), dtype, ("embed", "inner"),
                             fan_in_init(in_axis=0)),
        "conv_w": ParamSpec((dims.conv_width, dims.conv_dim), dtype,
                            (None, "inner"), normal_init(0.1)),
        "conv_b": ParamSpec((dims.conv_dim,), dtype, ("inner",), zeros_init),
        "a_log": ParamSpec((h,), torch.float32, ("inner",), a_init),
        "dt_bias": ParamSpec((h,), torch.float32, ("inner",), dt_bias_init),
        "d_skip": ParamSpec((h,), torch.float32, ("inner",), ones_init),
        "norm_scale": ParamSpec((di,), dtype, ("inner",), ones_init),
        "out_proj": ParamSpec((di, d), dtype, ("inner", "embed"),
                              fan_in_init(in_axis=0)),
    }


# ------------------------------------------------------------------ SSD core


def _mm(a: torch.Tensor, b: torch.Tensor, exact: bool) -> torch.Tensor:
    """``a @ b`` in float32 (operands widened): correctly rounded from
    float64 sums when ``exact``."""
    if exact:
        return exact_matmul(a.float(), b.float())
    return torch.matmul(a.float(), b.float())


def _cumsum(a: torch.Tensor, exact: bool) -> torch.Tensor:
    """Cumulative sum over the last axis: float32, or float64 (for
    `_segsum`'s differences to be taken there) when ``exact``."""
    return torch.cumsum(a.double() if exact else a, dim=-1)


def _segsum(a: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """(..., T) -> (..., T, T) lower-triangular pairwise cumulative sums:
    out[..., i, j] = sum(a[..., j+1:i+1]) for j <= i, -inf above the
    diagonal (float32)."""
    t = a.shape[-1]
    cum = _cumsum(a, exact)
    diff = (cum[..., :, None] - cum[..., None, :]).float()
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None, *,
                exact: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), a = dt * A (B, S, H) (negative), b_mat / c_mat
    (B, S, G, N), S a multiple of ``chunk``, h0 (B, H, P, N) the initial
    state. Returns (y (B, S, H, P) float32, final state (B, H, P, N)
    float32). ``exact``: see the module docstring."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc, l = s // chunk, chunk
    rep = h // g

    # the head axis split as (G, rep): head i reads group i // rep
    xc = x.reshape(bsz, nc, l, g, rep, p).permute(0, 1, 3, 4, 2, 5)
    ac = a.reshape(bsz, nc, l, g, rep).permute(0, 1, 3, 4, 2)  # b,c,G,r,l
    bc = b_mat.reshape(bsz, nc, l, g, n).permute(0, 1, 3, 2, 4)  # b,c,G,l,N
    cc = c_mat.reshape(bsz, nc, l, g, n).permute(0, 1, 3, 2, 4)
    bc, cc = bc.unsqueeze(3), cc.unsqueeze(3)                  # b,c,G,1,l,N

    a_cum = _cumsum(ac, exact).float()                         # b,c,G,r,l

    # 1. intra-chunk (diagonal blocks): (C B^T * L) X
    lmat = torch.exp(_segsum(ac, exact))                       # b,c,G,r,l,l
    scores = _mm(cc, bc.transpose(-1, -2), exact) * lmat
    y_diag = _mm(scores, xc, exact)                            # b,c,G,r,l,P

    # 2. per-chunk input states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # b,c,G,r,l
    states = _mm((xc.float() * decay_states[..., None]).transpose(-1, -2),
                 bc, exact)                                    # b,c,G,r,P,N

    # 3. inter-chunk recurrence, the state carried in float32 (the decay
    # factors are float32 exps)
    chunk_decay = torch.exp(a_cum[..., -1])                    # b,c,G,r
    prev = (h0.float().reshape(bsz, g, rep, p, n) if h0 is not None
            else torch.zeros((bsz, g, rep, p, n), device=x.device))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(prev)
        prev = prev * chunk_decay[:, c, ..., None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                      # b,c,G,r,P,N

    # 4. state contribution to outputs
    state_decay = torch.exp(a_cum)                             # b,c,G,r,l
    y_off = _mm(cc, h_prevs.transpose(-1, -2), exact) \
        * state_decay[..., None]                               # b,c,G,r,l,P

    y = (y_diag + y_off).permute(0, 1, 4, 2, 3, 5).reshape(bsz, s, h, p)
    return y, prev.reshape(bsz, h, p, n)


# ------------------------------------------------------------------ full layer


def _heads(dims: SSMDims, tp) -> Tuple[int, int]:
    """(count, first) of the heads this rank runs: all without ``tp``."""
    if tp is None:
        return dims.n_heads, 0
    if dims.n_groups != 1:
        raise NotImplementedError(
            f"an SSM split over the model ranks reads every group's B and "
            f"C; {dims.n_groups} groups are not split")
    return tp.chunk(dims.n_heads)


def _split_proj(z: torch.Tensor, dims: SSMDims, tp=None):
    """(z, x, B, C, dt) of in_proj's output: with ``tp`` this rank's heads'
    z, x and dt columns of the whole output, B and C whole."""
    di, gn = dims.d_inner, dims.n_groups * dims.d_state
    nh, h0 = _heads(dims, tp)
    p = dims.head_dim
    c0, c1 = h0 * p, (h0 + nh) * p
    dt0 = 2 * di + 2 * gn
    return (z[..., c0:c1], z[..., di + c0:di + c1],
            z[..., 2 * di:2 * di + gn], z[..., 2 * di + gn:dt0],
            z[..., dt0 + h0:dt0 + h0 + nh])


def _conv_weights(params, dims: SSMDims, dtype, tp=None):
    """The depthwise conv's (w, b) at the channels of `_split_proj`'s x | B
    | C: with ``tp`` the whole weights read through one `copy_to_model`
    copy (every rank convolves B and C; the gradient sums the ranks')."""
    w, b = params["conv_w"], params["conv_b"]
    if tp is not None:
        w = _conv_channels(copy_to_model(w, tp), dims, tp)
        b = _conv_channels(copy_to_model(b, tp), dims, tp)
    return w.to(dtype), b.to(dtype)


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, gate: torch.Tensor,
                d_inner: int, tp=None, eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2's gated RMS norm of ``y * silu(gate)`` over d_inner: the
    mean square summed in float64 and rounded once (over the model ranks'
    channels with ``tp``), the rest in float32, out in ``y``'s dtype."""
    x = y * F.silu(gate)
    ss = (x.double() ** 2).sum(dim=-1, keepdim=True)
    if tp is not None:
        ss = model_sum(ss, tp)
    var = (ss / d_inner).float()
    out = x.float() * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (W, C) depthwise causal conv, tap by tap in the
    reference's order."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _conv_tail(conv_in: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width - 1`` positions of the conv input (zero-padded in
    front for a shorter sequence): the decode cache's conv history."""
    tail = conv_in[:, -(width - 1):]
    pad = (width - 1) - tail.shape[1]
    return F.pad(tail, (0, 0, pad, 0)) if pad > 0 else tail


# how each recurrent projection runs split over the model ranks
TP_KINDS = {"in_proj": "column", "gate_proj": "column", "out_proj": "row",
            "w_a": "row_scatter", "w_x": "row_scatter"}


def _mm_fn(params, qcfg, comp, name, dtype, w_eff, tp=None):
    def mm(key, xin):
        unit = f"{name}/{key}"
        return quantized_mm(params, key, xin, qcfg=qcfg, comp=comp,
                            name=name, dtype=dtype,
                            w_eff=None if w_eff is None else w_eff.get(unit),
                            tp=None if tp is None else (tp, TP_KINDS[key]))
    return mm


def _mixer_input(x, qcfg: QuantConfig, tp):
    """A recurrent mixer's input as its first projections read it
    (fake-quantized under QAT); with ``tp`` through one `copy_to_model`
    copy (float64 under QAT), whose backward sums the ranks' gradients."""
    xin = lm_fake_quant_act(x, qcfg)
    if tp is None:
        return xin
    return read_as(xin, copy_to_model(
        x, tp, qcfg.enabled or qcfg.batch_invariant))


def apply_ssm(params, x: torch.Tensor, dims: SSMDims, *,
              qcfg: QuantConfig = QuantConfig.off(), comp=None,
              name: str = "ssm", return_state: bool = False, w_eff=None,
              tp=None):
    """Training/prefill path over x (B, S, d_model). With ``return_state``
    also returns the decode cache ({"state", "conv"}) at the end of the
    sequence. S is padded at the end to a multiple of ``dims.chunk``
    inside the SSD. ``w_eff``: {"ssm/in_proj": fake-quantized weight, ...}
    where the model computed them. ``tp``: this rank's heads (module
    docstring); the state is theirs, the conv history every channel's."""
    bsz, s, _ = x.shape
    exact = qcfg.batch_invariant
    collector = routing_stats.get_collector()
    if collector is not None:
        collector("ssm", name, routing_stats.mean_square(x))
    mm = _mm_fn(params, qcfg, comp, name, x.dtype, w_eff, tp)

    z = mm("in_proj", _mixer_input(x, qcfg, tp))
    if tp is not None:      # the stored chunks, put together by heads
        z = gather_from_model(z, tp, -1, summed=True,
                              exact=qcfg.enabled or exact)
    zg, xi, b_mat, c_mat, dt_raw = _split_proj(z, dims, tp)

    conv_out = F.silu(_causal_depthwise_conv(
        torch.cat([xi, b_mat, c_mat], dim=-1),
        *_conv_weights(params, dims, x.dtype, tp)))
    di, gn = xi.shape[-1], dims.n_groups * dims.d_state
    xi, b_mat, c_mat = (conv_out[..., :di], conv_out[..., di:di + gn],
                        conv_out[..., di + gn:])

    h = di // dims.head_dim
    xh = xi.reshape(bsz, s, h, dims.head_dim)
    bg = b_mat.reshape(bsz, s, dims.n_groups, dims.d_state)
    cg = c_mat.reshape(bsz, s, dims.n_groups, dims.d_state)

    dt = softplus(dt_raw.float() + params["dt_bias"])           # (B, S, H)
    a_neg = -torch.exp(params["a_log"])                         # (H,)
    a_dt = dt * a_neg
    x_dt = xh * dt[..., None].to(xh.dtype)

    pad = (-s) % dims.chunk
    if pad:
        x_dt = F.pad(x_dt, (0, 0, 0, 0, 0, pad))
        a_dt = F.pad(a_dt, (0, 0, 0, pad))
        bg = F.pad(bg, (0, 0, 0, 0, 0, pad))
        cg = F.pad(cg, (0, 0, 0, 0, 0, pad))

    y, final_state = ssd_chunked(x_dt, a_dt, bg, cg, dims.chunk, exact=exact)
    if pad:
        y = y[:, :s]
    y = y.to(xh.dtype)  # SSD internals accumulate f32; back to stream dtype
    y = y + xh * params["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(bsz, s, di)

    # gated RMSNorm (mamba2) then out projection
    y = _gated_norm(params["norm_scale"], y, zg, dims.d_inner, tp)
    out = mm("out_proj", lm_fake_quant_act(y, qcfg, tp))
    if return_state:         # the history of every channel: x | B | C
        conv_in = z[..., dims.d_inner:dims.d_inner + dims.conv_dim]
        return out, {"state": final_state.float(),
                     "conv": _conv_tail(conv_in, dims.conv_width)}
    return out


def ssm_cache_spec(batch: int, dims: SSMDims, dtype=torch.float32) -> dict:
    """{"state", "conv"}: shape-and-dtype placeholders (meta tensors)."""
    return {
        "state": torch.empty((batch, dims.n_heads, dims.head_dim,
                              dims.d_state), dtype=dtype, device="meta"),
        "conv": torch.empty((batch, dims.conv_width - 1, dims.conv_dim),
                            dtype=dtype, device="meta"),
    }


def init_ssm_cache(batch: int, dims: SSMDims, dtype=torch.float32, *,
                   device) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in ssm_cache_spec(batch, dims, dtype).items()}


def apply_ssm_decode(params, x: torch.Tensor, cache: dict, dims: SSMDims, *,
                     qcfg: QuantConfig = QuantConfig.off(), comp=None,
                     name: str = "ssm", w_eff=None, tp=None
                     ) -> Tuple[torch.Tensor, dict]:
    """One decode step: x (B, 1, d_model), cache {"state" (B, H, P, N),
    "conv" (B, W-1, conv_dim)}. Returns (output (B, 1, d), new cache, in
    the cache's dtypes). ``tp``: this rank's heads, as `apply_ssm`; the
    cache's ``state`` holds them, its ``conv`` every channel, and so does
    the new cache."""
    bsz = x.shape[0]
    exact = qcfg.batch_invariant
    mm = _mm_fn(params, qcfg, comp, name, x.dtype, w_eff, tp)

    z = mm("in_proj", _mixer_input(x, qcfg, tp))
    if tp is not None:
        z = gather_from_model(z, tp, -1, summed=True)
    z = z[:, 0]
    zg, xi, b_mat, c_mat, dt_raw = _split_proj(z, dims, tp)

    conv_in = z[:, None, dims.d_inner:dims.d_inner + dims.conv_dim]
    hist = torch.cat([cache["conv"].to(x.dtype), conv_in],
                     dim=1)                                    # (B, W, C)
    new_conv = hist[:, 1:].to(cache["conv"].dtype)
    # this rank's channels of the whole history
    conv_hist = hist if tp is None else _conv_channels(hist, dims, tp)
    w, b = _conv_weights(params, dims, x.dtype, tp)
    prods = conv_hist.double() * w.double() if exact \
        else conv_hist.float() * w.float()
    conv_out = prods.sum(dim=1).to(x.dtype) + b
    conv_out = F.silu(conv_out).to(x.dtype)

    di, gn = xi.shape[-1], dims.n_groups * dims.d_state
    xi, b_vec, c_vec = (conv_out[..., :di], conv_out[..., di:di + gn],
                        conv_out[..., di + gn:])

    h, p, n = di // dims.head_dim, dims.head_dim, dims.d_state
    rep = h // dims.n_groups
    xh = xi.reshape(bsz, h, p)
    bg = b_vec.reshape(bsz, dims.n_groups, n).repeat_interleave(rep, dim=1)
    cg = c_vec.reshape(bsz, dims.n_groups, n).repeat_interleave(rep, dim=1)

    dt = softplus(dt_raw.float() + params["dt_bias"])           # (B, H)
    a_neg = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a_neg)                               # (B, H)

    state = cache["state"].float()
    upd = (xh * dt[..., None].to(xh.dtype))[..., None] * bg[:, :, None, :]
    new_state = state * decay[..., None, None] + upd.float()
    y = _mm(new_state.to(xh.dtype), cg[..., None], exact)[..., 0] \
        .to(xh.dtype)                                           # (B, H, P)
    y = y + xh * params["d_skip"][None, :, None].to(xh.dtype)
    y = y.reshape(bsz, 1, di)

    y = _gated_norm(params["norm_scale"], y, zg[:, None], dims.d_inner, tp)
    out = mm("out_proj", lm_fake_quant_act(y, qcfg, tp))
    return out, {"state": new_state.to(cache["state"].dtype),
                 "conv": new_conv}


def _conv_channels(t: torch.Tensor, dims: SSMDims, tp) -> torch.Tensor:
    """The channels of a whole (..., conv_dim) tensor that this rank
    convolves: its heads' x, then B and C."""
    nh, h0 = _heads(dims, tp)
    c0, c1 = h0 * dims.head_dim, (h0 + nh) * dims.head_dim
    return torch.cat([t[..., c0:c1], t[..., dims.d_inner:]], dim=-1)
