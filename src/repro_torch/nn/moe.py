"""Mixture-of-Experts FFN with capacity-based scatter dispatch, GShard style
(port of `repro.nn.moe`).

Dispatch is per batch row: each row computes its own top-k routing, its
tokens' slots (a cumulative count over the row's sequence of choices) and a
capacity-bounded scatter into a (B, E, C, d) buffer, so a row's routing
never depends on its batch-mates. A capacity depends on the call's sequence
length (`capacity`), so a chunked prefill and a one-shot one can drop
different tokens, in the JAX package too.

The router picks the top k probabilities with the lower expert index first
on a tie (``jax.lax.top_k``'s rule; `torch.topk` does not promise one), by a
stable descending sort. Under `QuantConfig.batch_invariant` (the serving
engine) the router's product is correctly rounded (`exact_matmul`), so a
row's choice does not depend on the call's row count, and the expert
activations are fake-quantized one scale a token slot. Kept rows scatter to
their (row, expert, slot) by plain assignment: kept slots are distinct, and
dropped rows go to one spare slot past the capacity that is cut off after,
which gives JAX's values (its dropped rows add zeros into slot C - 1)
without an accumulating scatter's unordered sums. The sum over the k
choices and the means of the aux losses sum in float64 and round once.

Expert weights are (E, d, f). Under QAT each expert has its own
per-output-channel scales and codebook (the JAX package vmaps the
fake-quant over the expert axis): the model hands `apply_moe` the weights
its one grouped K3 launch fake-quantized, experts as candidates
(`LMModel._fake_quant_units`); called alone it makes that launch itself. On
the serve path every expert's matmul runs on the LUT GEMM (K2) from its own
slice of the stacked artifact, one launch an (expert, matrix), at M = B x C.
Shared (always-on) experts (the moonshot family) are plain FFN matrices.

**In a meshed step** (``tp=``, the splits of `repro_torch.distributed
.sharding.MOE_SPLITS`) every model rank holds the same rows and the same
router, so it makes the same routing, slots and scatter. With the experts
split (``expert`` -> "model", the default rules: expert parallelism) a
rank runs only its chunk of the experts on its slice of the (B, E, C, d)
buffer, then the ranks' outputs are all-gathered (`gather_from_model`,
whose backward keeps this rank's chunk of the gradient) and the gather,
gate and float64 sum over k run as unsplit, so the forward is the
unsplit one bit for bit. The scatter reads a `copy_to_model` copy of x,
so the gradient that reaches x through the buffer (each rank's covers
only its experts' slots) is summed over the model ranks, in float64
under QAT, and rounded once; the router's path and the aux losses are
the same on every model rank and are not summed over them. With
``expert=None, moe_ff=model`` (tensor-parallel experts) a rank runs every
expert at its chunk of the hidden width: w_gate and w_up column-parallel
on one copy of the buffer, w_down row-parallel, their float64 partial
sums all-reduced and rounded once (`tp_matmul`). The buffer's amax is the
whole buffer's on every rank, the hidden activation's a MAX over the
model ranks. Shared experts split their hidden width (``mlp``) as the
dense FFN. Under QAT the model's one K3 launch fake-quantizes only this
rank's experts (or hidden-width chunks), from its slices.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import qat, routing_stats
from repro_torch.core.export import ServeArtifact, serve_dense
from repro_torch.distributed.sharding import (
    batch_reduce,
    copy_to_model,
    gather_from_model,
    read_as,
    tp_matmul,
)
from repro_torch.kernels.lut_matmul.ref import exact_matmul
from repro_torch.models.config import MoEDims
from repro_torch.nn.layers import (
    QuantConfig,
    gelu,
    lm_fake_quant_act,
    quantized_mm,
)
from repro_torch.nn.spec import ParamSpec, fan_in_init, normal_init

__all__ = ["MoEDims", "apply_moe", "capacity", "make_moe_spec",
           "reset_dispatch_constraint", "set_dispatch_constraint", "top_k"]


# Optional dispatch-buffer hook (set by a meshed train step with
# ``moe_local_dispatch``): hook(tensor, kind), kind in {"scatter",
# "expert"}. In the JAX package it pins the (B, E, C, d) buffer's layout
# for the SPMD partitioner (the scatter local, then E over "model"); here
# every rank scatters its rows locally and slices its experts in any
# case, so the hook returns its tensor unchanged.
_DISPATCH_CONSTRAINT: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("moe_dispatch_constraint", default=None)


def set_dispatch_constraint(fn: Optional[Callable]):
    """Returns a contextvars token; reset with the token when done
    (`reset_dispatch_constraint`)."""
    return _DISPATCH_CONSTRAINT.set(fn)


def reset_dispatch_constraint(token) -> None:
    _DISPATCH_CONSTRAINT.reset(token)


def dispatch_constraint() -> Optional[Callable]:
    return _DISPATCH_CONSTRAINT.get()


def make_moe_spec(dims: MoEDims, dtype=torch.float32) -> dict:
    d, e, f = dims.d_model, dims.n_experts, dims.d_ff
    spec = {
        "router": ParamSpec((d, e), torch.float32, ("embed", None),
                            normal_init(0.02)),
        "w_gate": ParamSpec((e, d, f), dtype,
                            ("expert", "moe_embed", "moe_ff"),
                            fan_in_init(in_axis=1)),
        "w_up": ParamSpec((e, d, f), dtype,
                          ("expert", "moe_embed", "moe_ff"),
                          fan_in_init(in_axis=1)),
        "w_down": ParamSpec((e, f, d), dtype,
                            ("expert", "moe_ff", "moe_embed"),
                            fan_in_init(in_axis=1)),
    }
    if dims.n_shared:
        fs = f * dims.n_shared
        spec["shared_gate"] = ParamSpec((d, fs), dtype, ("embed", "mlp"),
                                        fan_in_init(in_axis=0))
        spec["shared_up"] = ParamSpec((d, fs), dtype, ("embed", "mlp"),
                                      fan_in_init(in_axis=0))
        spec["shared_down"] = ParamSpec((fs, d), dtype, ("mlp", "embed"),
                                        fan_in_init(in_axis=0))
    return spec


def _act(h_gate, h_up, kind: str):
    if kind == "swiglu":
        return F.silu(h_gate) * h_up
    if kind == "geglu":
        return gelu(h_gate) * h_up
    return gelu(h_gate)


def capacity(dims: MoEDims, seq_len: int) -> int:
    c = int(dims.top_k * seq_len * dims.capacity_factor / dims.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, largest
    first and the lower index first on a tie (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_slice(art: ServeArtifact, ei: int) -> ServeArtifact:
    return dataclasses.replace(art, packed=art.packed[ei],
                               codebook=art.codebook[ei],
                               scale=art.scale[ei])


def fake_quant_experts(w: torch.Tensor, comp) -> torch.Tensor:
    """(E, ...) expert weights fake-quantized alone (one grouped K3 call):
    with a per-expert comp (codebook (E, 32)) each expert as a candidate
    with its own scales, as the JAX package's vmap; with one codebook for
    the whole tensor, as one weight."""
    if comp is not None and comp["codebook"].ndim == 2:
        return qat.fake_quant_weights([w], [comp], w.shape[0])[0]
    return qat.fake_quant_weights([w], [comp])[0]


def _sum_f64(x: torch.Tensor, dim) -> torch.Tensor:
    return x.sum(dim=dim, dtype=torch.float64).to(x.dtype)


def _by_expert(mm, xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``mm(xin, w)`` of the (B, E, C, in) buffer and the (E, in, out)
    experts, run as one product an expert, (E, B x C, in) @ (E, in, out):
    a product broadcast over B would copy every expert's weight once a
    row (and its gradient once a row in the backward)."""
    b, e, c, k = xin.shape
    y = mm(xin.transpose(0, 1).reshape(e, b * c, k), w)
    return y.reshape(e, b, c, y.shape[-1]).transpose(0, 1)


def apply_moe(params, x: torch.Tensor, dims: MoEDims, *,
              qcfg: QuantConfig = QuantConfig.off(), comp=None,
              name: str = "moe", w_eff=None,
              tp=None) -> Tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (output (B, S, d), aux {"lb_loss", "z_loss",
    "dropped_frac"}, 0-d float32). ``w_eff``: {"moe/w_gate": the (E, d, f)
    fake-quantized experts, ...} where the model computed them. ``tp``:
    {"experts": split, "expert_ff": split, "shared": split}, the splits of
    a meshed step (`repro_torch.distributed.sharding.LayerGather
    .block_splits`; the parameters are then this rank's chunks): module
    docstring."""
    b, s, d = x.shape
    e, k = dims.n_experts, dims.top_k
    c = capacity(dims, s)
    exact = qcfg.batch_invariant
    dev = x.device
    tp = tp or {}
    ep, ff, sh = (tp.get(n) for n in ("experts", "expert_ff", "shared"))
    if ep is not None and ff is not None:
        raise NotImplementedError(
            f"experts split over {ep.axes} and their hidden width over "
            f"{ff.axes} at once")
    grad64 = qcfg.enabled or exact      # the ranks' gradient sums' dtype
    copies: dict = {}

    def copy_of(split):
        """``x`` as the model ranks of ``split`` share it: one copy a
        group, whose backward sums their gradients (`copy_to_model`)."""
        if split.axes not in copies:
            copies[split.axes] = copy_to_model(x, split, grad64)
        return copies[split.axes]

    x32 = x.float()
    router = params["router"].float()
    logits = exact_matmul(x32, router) if exact \
        else torch.matmul(x32, router)                       # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                           # (B, S, k)
    top_p = top_p / torch.clamp(_sum_f64(top_p, -1)[..., None], min=1e-9)

    # ---- slots within each expert buffer (per batch row)
    expert = top_e.reshape(b, s * k)
    onehot = F.one_hot(expert, e)                            # (B, S*k, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.gather(before, 2, expert[..., None])[..., 0]
    keep = slot < c
    gate = (top_p.reshape(b, s * k) * keep).to(x.dtype)

    collector = routing_stats.get_collector()
    if collector is not None:
        # per-expert kept-dispatch counts: dropped tokens never reach the
        # expert matmuls, so they carry no expert energy
        collector("moe", name, (onehot * keep[..., None]).sum(dim=(0, 1)))

    # ---- scatter tokens into (B, E, C, d); dropped rows to spare slot C.
    # Split experts: each rank sees only its experts' slots, so the
    # gradient that reaches x through the buffer is summed over the model
    # ranks (the scatter reads x's shared copy)
    src = x if ep is None else copy_of(ep)
    xk = torch.repeat_interleave(src, k, dim=1)              # (B, S*k, d)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    hook = dispatch_constraint()
    buf = src.new_zeros((b, e, c + 1, d)).index_put(
        (bidx, expert, torch.where(keep, slot, c)), xk)[:, :, :c].to(x.dtype)
    if hook is not None:
        buf = hook(hook(buf, "scatter"), "expert")

    def act_q(a, split=None):
        """``a`` (B, E, C, ...) fake-quantized, one scale a slot under
        ``batch_invariant``; ``split``: ``a`` is this rank's chunk."""
        return lm_fake_quant_act(a, qcfg, split, token_dims=3)

    def expert_mm(key, xin):
        """(B, E, C, in) @ expert weights -> (B, E, C, out) (this rank's
        experts, or its chunk of their hidden width); one LUT GEMM an
        expert on the serve path."""
        unit = f"{name}/{key}"
        cmp = None if comp is None else comp.get(unit)
        art = None if cmp is None else cmp.get("serve")
        if qcfg.enabled and qcfg.comp_mode == "serve" and art is not None:
            if tp:
                raise NotImplementedError(
                    "served experts split over the model ranks (the meshed "
                    "steps run without artifacts)")
            outs = [serve_dense(xin[:, ei], _expert_slice(art, ei))
                    for ei in range(e)]
            return torch.stack(outs, dim=1).to(x.dtype)
        w = params[key]
        if qcfg.enabled:
            w = None if w_eff is None else w_eff.get(unit)
            if w is None:
                w = fake_quant_experts(
                    params[key], None if cmp is None
                    else {ck: cv for ck, cv in cmp.items() if ck != "serve"})
        w = w.to(x.dtype)
        if ff is not None:
            return _by_expert(lambda a, b: tp_matmul(
                a, b, ff, "row" if key == "w_down" else "column",
                qcfg.enabled or exact), xin, w).to(x.dtype)
        if qcfg.enabled or exact:
            return _by_expert(exact_matmul, xin, w).to(x.dtype)
        return _by_expert(torch.matmul, xin, w)

    # the whole buffer's amax (every model rank holds it), then this rank's
    # experts, or its copy for the column products over the hidden width
    h_in = act_q(buf)
    if ep is not None:
        e_loc, e0 = ep.chunk(e)
        h_in = h_in[:, e0:e0 + e_loc]
    elif ff is not None:
        h_in = read_as(h_in, copy_to_model(buf, ff, grad64))
    h = _act(expert_mm("w_gate", h_in), expert_mm("w_up", h_in), dims.ffn)
    out_buf = expert_mm("w_down", act_q(h, ep or ff))
    if ep is not None:              # every expert's outputs on every rank
        out_buf = gather_from_model(out_buf, ep, 1)          # (B, E, C, d)

    # ---- gather back, weight by gate, sum over the k choices
    slot_safe = torch.where(keep, slot, c - 1)
    y = out_buf[bidx, expert, slot_safe] * gate[..., None]   # (B, S*k, d)
    y = _sum_f64(y.reshape(b, s, k, d), 2)

    # ---- shared experts
    if dims.n_shared:
        xin = lm_fake_quant_act(x, qcfg)
        if sh is not None:
            xin = read_as(xin, copy_of(sh))

        def shared_mm(key, h_in):
            unit = f"{name}/{key}"
            return quantized_mm(params, key, h_in, qcfg=qcfg, comp=comp,
                                name=name, dtype=x.dtype,
                                w_eff=None if w_eff is None
                                else w_eff.get(unit),
                                tp=None if sh is None else (
                                    sh, "row" if key == "shared_down"
                                    else "column"))

        h_sh = _act(shared_mm("shared_gate", xin),
                    shared_mm("shared_up", xin), dims.ffn)
        y = y + shared_mm("shared_down", h_sh)

    # ---- aux losses (Switch/GShard load balance + z-loss), float64 sums;
    # in a meshed step whose batch is split, the token sums and counts are
    # the global batch's (lb_loss is a product of two token means)
    red = batch_reduce()
    total = (lambda t: t) if red is None else red.sum
    n_tok = b * s
    n_all = n_tok if red is None else int(total(
        torch.tensor(float(n_tok), dtype=torch.float64, device=dev)))
    me = total(probs.reshape(-1, e).sum(dim=0, dtype=torch.float64)) / n_all
    ce = total(onehot.reshape(n_tok, k, e).sum(dim=(0, 1),
                                               dtype=torch.float64)) / n_all
    lb_loss = (e * (me * ce).sum() / k).float()
    z = torch.logsumexp(logits, dim=-1)
    if red is None:
        z_loss = (z.double() ** 2).mean().float()
    else:
        z_loss = (total((z.double() ** 2).sum()) / n_all).float()
    dropped = (1.0 - total(keep.sum(dtype=torch.float64))
               / (n_all * k)).float()
    return y, {"lb_loss": lb_loss, "z_loss": z_loss, "dropped_frac": dropped}
