"""Layer library: compressible Dense/Conv, batch norm and pools, and the LM
layers (RMS/layer norms, embeddings, `quantized_mm`); port of
`repro.nn.layers`.

Every layer is a (make_*_spec, apply_*) pair over plain parameter dicts.
Layouts are the JAX package's: activations NHWC, conv kernels HWIO, dense
weights (in, out). Compressible layers accept an optional per-layer
compression state (`repro_torch.core.qat.CompState`) and a `QuantConfig`,
and an optional ``w_eff``: the layer's weight already fake-quantized by the
model's one grouped call (`repro_torch.core.qat.fake_quant_weights`); a
layer called alone without it makes that grouped call for itself.

Candidates. The batched schedule sweep runs n candidate variants of a model
in one forward (the JAX package's ``vmap``, written out): parameters, state
and comps carry a leading candidate axis n, and activations carry it just
before their last axis, (B, H, W, n, C) and (B, n, F), so candidates ride
as extra channels. A conv is then one grouped convolution, and every
per-tensor or per-channel reduction (activation scale, batch-norm
statistics, pools) stays one a candidate; each candidate's slice is what a
forward of that candidate alone computes. The network's input is shared,
(B, H, W, C), with no candidate axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import qat
from repro_torch.core.export import serve_conv, serve_dense
from repro_torch.core.stats import same_pad_nhwc
from repro_torch.distributed.sharding import batch_reduction, tp_matmul
from repro_torch.kernels.lut_matmul.ref import ACTIVATIONS, exact_matmul
from repro_torch.nn.spec import (
    ParamSpec,
    fan_in_init,
    normal_init,
    ones_init,
    zeros_init,
)

__all__ = [
    "ACTIVATIONS", "QuantConfig", "apply_batchnorm", "apply_conv",
    "apply_dense", "apply_embed", "apply_layernorm", "apply_rmsnorm",
    "apply_unembed", "avg_pool_global", "gelu", "make_batchnorm_spec",
    "make_batchnorm_state", "make_conv_spec", "make_dense_spec",
    "make_embed_spec", "make_layernorm_spec", "make_rmsnorm_spec",
    "max_pool", "quantized_mm",
]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization switches.

    ``comp_mode`` selects how a compressed layer executes:
      * ``"fake_quant"`` — dense matmul on fake-quantized weights (the QAT
        reference forward);
      * ``"serve"`` — layers that have a `ServeArtifact` run on the packed
        4-bit LUT GEMM; a layer without an artifact serves on fake-quant
        (that per-layer rule is semantics, not a device fallback).

    ``use_ref_kernel`` is kept so configs and plans cross-load with the JAX
    package. It selects nothing here: CPU tensors always take the plain
    LUT-GEMM version and CUDA tensors always launch the kernel.

    ``batch_invariant`` makes every row's result a function of that row
    alone, whatever else the call holds (the serving engine's setting: a
    request's tokens must not depend on its batch-mates, its padding or how
    its prompt was chunked). The LM's activation fake-quant then takes one
    scale a token position instead of the JAX package's one a call, and the
    LM's norm statistics, softmax sums, attention products, unembedding and
    unquantized projections are float64 sums rounded once
    (`exact_matmul`), since a float32 sum on the card takes an order
    chosen from the call's row count. Off, the forward computes the JAX
    package's function with float32 sums.
    """

    enabled: bool = False
    act_quant: bool = True
    comp_mode: str = "fake_quant"
    use_ref_kernel: bool = False
    batch_invariant: bool = False

    @staticmethod
    def off() -> "QuantConfig":
        return QuantConfig(enabled=False)

    @staticmethod
    def on() -> "QuantConfig":
        return QuantConfig(enabled=True)

    @staticmethod
    def serve(*, use_ref_kernel: bool = False) -> "QuantConfig":
        return QuantConfig(enabled=True, comp_mode="serve",
                           use_ref_kernel=use_ref_kernel)


def lm_fake_quant_act(x: torch.Tensor, qcfg: QuantConfig,
                      split=None, token_dims: int = 2) -> torch.Tensor:
    """An LM activation (B, S, ...) as the quantized matmul that follows it
    reads it: fake-quantized under QAT (one scale a call, or one a token
    position when ``qcfg.batch_invariant``: its leading ``token_dims``
    dims index the tokens, 3 for the MoE's (B, E, C) slots), unchanged
    otherwise. ``split`` (a `repro_torch.distributed.sharding.ModelSplit`):
    the activation's features are split over model ranks, so its one amax
    is a MAX over them too (and over the batch ranks); with
    ``qcfg.batch_invariant`` (per-token scales, which no meshed step sets)
    it raises."""
    if not (qcfg.enabled and qcfg.act_quant):
        return x
    token_dims = token_dims if qcfg.batch_invariant else 0
    if split is None:
        return qat.fake_quant_act(x, token_dims=token_dims)
    if token_dims:
        raise NotImplementedError(
            "a per-token activation scale on features split over the model "
            "ranks (batch_invariant in a tensor-parallel step): its amax "
            "would be each rank's alone")
    with batch_reduction(split.act):
        return qat.fake_quant_act(x, token_dims=token_dims)


def _serves(qcfg: QuantConfig, serve_art) -> bool:
    return qcfg.enabled and qcfg.comp_mode == "serve" and serve_art is not None


def _record_tap(tap, tap_name, x, w, comp):
    """Profiling tap: int8 views of what sits in the MAC registers. Recorded
    on both the fake-quant and serve paths (the served weights dequantize to
    the same integers the tap reports)."""
    if tap is not None and tap_name is not None:
        tap[tap_name] = {"a_int": qat.quantize_act_int(x),
                         "w_int": qat.quantize_weight_int(w, comp)}


def _fake_quant_alone(w, comp, qcfg: QuantConfig, cands: bool):
    """A layer's fake-quantized weight when the model did not hand it one:
    one grouped call for this layer alone."""
    if not qcfg.enabled:
        return w
    return qat.fake_quant_weights([w], [comp],
                                  w.shape[0] if cands else None)[0]


def _channel_sum(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``g`` summed to the shape of ``like``, a per-channel tensor (C,) or
    (n, C) broadcast over ``g``'s leading axes, in float64 and rounded once:
    a float32 sum's order depends on how many channels and candidates share
    the call, and the batched schedule sweep needs each candidate's
    gradient to be the one it gets alone."""
    dims = tuple(range(g.ndim - like.ndim))
    return g.sum(dim=dims, dtype=torch.float64).to(like.dtype)


class _AddBias(torch.autograd.Function):
    """``y + b``, float32; backward ``g`` and `_channel_sum` of ``g``."""

    @staticmethod
    def forward(ctx, y, b):
        ctx.save_for_backward(b)
        return y + b

    @staticmethod
    def backward(ctx, g):
        (b,) = ctx.saved_tensors
        return g, _channel_sum(g, b)


class _Normalize(torch.autograd.Function):
    """``(x - mean) * inv + bias``, float32 elementwise, as the JAX
    package's batch norm; backward the same elementwise gradient to ``x``,
    and per-channel gradients of ``mean``, ``inv`` and ``bias`` through
    `_channel_sum`."""

    @staticmethod
    def forward(ctx, x, mean, inv, bias):
        t = x - mean
        ctx.save_for_backward(t, inv)
        return t * inv + bias

    @staticmethod
    def backward(ctx, g):
        t, inv = ctx.saved_tensors
        g_t = g * inv
        return (g_t, -_channel_sum(g_t, inv), _channel_sum(g * t, inv),
                _channel_sum(g, inv))


def _epilogue(y, params, activation, residual):
    if "b" in params:
        y = _AddBias.apply(y, params["b"].to(y.dtype))
    y = ACTIVATIONS[activation](y)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y


# --------------------------------------------------------------------- dense


def make_dense_spec(in_dim: int, out_dim: int, *, use_bias: bool = True,
                    dtype=torch.float32,
                    axes: Tuple[Optional[str], Optional[str]] = (None, None),
                    init=None):
    spec = {"w": ParamSpec((in_dim, out_dim), dtype, axes,
                           init or fan_in_init())}
    if use_bias:
        spec["b"] = ParamSpec((out_dim,), dtype, (axes[1],), zeros_init)
    return spec


def apply_dense(params, x: torch.Tensor, *,
                qcfg: QuantConfig = QuantConfig.off(),
                comp: Optional[qat.CompState] = None, serve_art=None,
                activation: str = "none",
                residual: Optional[torch.Tensor] = None,
                tap: Optional[dict] = None,
                tap_name: Optional[str] = None,
                w_eff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer with an optional fused epilogue:
    ``y = act(x @ w + b) + residual``. On the serve path bias, activation and
    residual ride the LUT-GEMM kernel epilogue (one launch). A ``tap`` dict
    receives the layer's int8 input and weights under ``tap_name``.
    ``w_eff``: the fake-quantized weight, where the caller computed it.
    Candidates: ``w`` (n, in, out) and ``x`` (B, n, in) give (B, n, out),
    one batched product."""
    w = params["w"]
    cands = w.ndim == 3
    if qcfg.enabled and qcfg.act_quant:
        x = qat.fake_quant_act(x, -2 if cands else None)
    _record_tap(tap, tap_name, x, w, comp)
    if _serves(qcfg, serve_art):
        return serve_dense(x, serve_art, bias=params.get("b"),
                           residual=residual, activation=activation)
    if w_eff is None:
        w_eff = _fake_quant_alone(w, comp, qcfg, cands)
    if cands:
        y = exact_matmul(x.transpose(0, 1), w_eff).transpose(0, 1)
    else:
        y = exact_matmul(x, w_eff)
    return _epilogue(y.to(x.dtype), params, activation, residual)


def quantized_mm(params, key, xin, *, qcfg: QuantConfig, comp, name: str,
                 dtype, w_eff: Optional[torch.Tensor] = None,
                 tp=None) -> torch.Tensor:
    """``xin @ params[key]`` for a named compressible unit: on the packed LUT
    GEMM when a `ServeArtifact` is attached and ``comp_mode == "serve"``,
    else on the fake-quantized weight (``w_eff`` where the caller computed
    it) under QAT, as a correctly rounded product (`exact_matmul`: float64
    sums, one rounding), so the two agree to float32 ulps; without QAT a
    plain product (correctly rounded under ``qcfg.batch_invariant``).
    ``tp``: (split, ``"column"`` or ``"row"``) of a tensor-parallel unit
    whose weight is this rank's chunk (`tp_matmul`: the same product,
    float64 partial sums added across the ranks before the one rounding;
    a column unit's ``xin`` is its sub-module's `copy_to_model` copy)."""
    c = None if comp is None else comp.get(f"{name}/{key}")
    art = None if c is None else c.get("serve")
    if _serves(qcfg, art):
        return serve_dense(xin, art).to(dtype)
    w = params[key]
    if qcfg.enabled:
        w = _fake_quant_alone(w, c, qcfg, False) if w_eff is None else w_eff
    exact = qcfg.enabled or qcfg.batch_invariant
    if tp is not None:
        return tp_matmul(xin, w.to(dtype), *tp, exact).to(dtype)
    if exact:
        return exact_matmul(xin, w.to(dtype)).to(dtype)
    return torch.matmul(xin, w.to(dtype))


# --------------------------------------------------------------------- conv2d


def make_conv_spec(c_in: int, c_out: int, kernel: int, *,
                   use_bias: bool = True, dtype=torch.float32, init=None):
    spec = {"w": ParamSpec((kernel, kernel, c_in, c_out), dtype,
                           (None, None, None, None), init or fan_in_init())}
    if use_bias:
        spec["b"] = ParamSpec((c_out,), dtype, (None,), zeros_init)
    return spec


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
              padding: str) -> torch.Tensor:
    """``lax.conv_general_dilated`` with NHWC/HWIO/NHWC dimension numbers,
    correctly rounded like `exact_matmul` (float64 sums, one rounding).

    Candidates: ``w`` (n, kh, kw, c_in, c_out) holds n kernels; ``x`` is
    (B, H, W, n, c_in), candidate j convolved with kernel j (one grouped
    convolution, candidates folded into channels), or a shared (B, H, W,
    c_in) that every kernel reads (one convolution of n * c_out outputs).
    The result is (B, Ho, Wo, n, c_out).

    SAME pads explicitly (`same_pad_nhwc`): torch's ``padding="same"``
    rejects stride > 1 and pads stride-2 convs differently."""
    kh, kw = w.shape[-4:-2]
    cands, groups = (w.shape[0] if w.ndim == 5 else None), 1
    if cands is None:
        w = w.permute(3, 2, 0, 1)
    else:
        if x.ndim == 5:
            x, groups = x.flatten(3), cands
        w = w.permute(0, 4, 3, 1, 2).flatten(0, 1)
    if padding == "SAME":
        x = same_pad_nhwc(x, (kh, kw), stride)
    elif padding != "VALID":
        raise ValueError(padding)
    y = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(), stride=stride,
                 groups=groups)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    return y if cands is None else y.unflatten(3, (cands, -1))


def apply_conv(params, x: torch.Tensor, *, stride: int = 1,
               padding: str = "SAME", qcfg: QuantConfig = QuantConfig.off(),
               comp: Optional[qat.CompState] = None, serve_art=None,
               activation: str = "none",
               residual: Optional[torch.Tensor] = None,
               tap: Optional[dict] = None,
               tap_name: Optional[str] = None,
               w_eff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC conv with HWIO kernel and an optional fused epilogue:
    ``y = act(conv(x, w) + b) + residual``. On the serve path the epilogue
    rides the im2col-fed LUT-GEMM kernel (one launch). A ``tap`` dict
    receives the layer's int8 input and weights under ``tap_name``.
    ``w_eff``: the fake-quantized weight, where the caller computed it.
    Candidates: see `conv_nhwc`; a shared input has one activation scale,
    a candidate axis one a candidate."""
    w = params["w"]
    if qcfg.enabled and qcfg.act_quant:
        x = qat.fake_quant_act(x, -2 if x.ndim == 5 else None)
    _record_tap(tap, tap_name, x, w, comp)
    if _serves(qcfg, serve_art):
        return serve_conv(x, serve_art, stride=stride, padding=padding,
                          bias=params.get("b"), residual=residual,
                          activation=activation)
    if w_eff is None:
        w_eff = _fake_quant_alone(w, comp, qcfg, w.ndim == 5)
    y = conv_nhwc(x, w_eff.to(x.dtype), stride, padding)
    return _epilogue(y, params, activation, residual)


# --------------------------------------------------------------------- norms


def make_batchnorm_spec(dim: int, dtype=torch.float32):
    return {
        "scale": ParamSpec((dim,), dtype, (None,), ones_init),
        "bias": ParamSpec((dim,), dtype, (None,), zeros_init),
    }


def make_batchnorm_state(dim: int, dtype=torch.float32):
    return {
        "mean": ParamSpec((dim,), dtype, (None,), zeros_init),
        "var": ParamSpec((dim,), dtype, (None,), ones_init),
    }


def apply_batchnorm(params, state, x: torch.Tensor, *, train: bool,
                    momentum: float = 0.9, eps: float = 1e-5):
    """Returns (y, new_state). Reduces over all axes but the channel (last)
    and, where ``params`` carry a candidate axis ((n, C) leaves), the
    candidate axis before it: statistics and running state are one a
    candidate.

    The batch statistics and the per-channel ``rsqrt(var + eps) * scale``
    are computed in float64 and rounded once; the normalisation itself is
    float32, elementwise. Float32 reductions and ``rsqrt`` differ in the
    last bit between the CPU and the card, and at depth such a bit moves an
    activation across a `fake_quant_act` rounding boundary; so the forward
    gives the same bits on both, like the convolutions (`conv_nhwc`); the
    backward's per-channel sums are float64 too (`_Normalize`). In train
    mode the running state is detached from the graph (the JAX
    package's state output carries no gradient; here it would chain every
    step's graph)."""
    reduce_axes = tuple(range(x.ndim - params["scale"].ndim))
    if train:
        xd = x.double()
        mean = xd.mean(dim=reduce_axes)
        var = xd.var(dim=reduce_axes, unbiased=False)
        new_state = {
            "mean": momentum * state["mean"]
            + (1 - momentum) * mean.detach().to(state["mean"].dtype),
            "var": momentum * state["var"]
            + (1 - momentum) * var.detach().to(state["var"].dtype),
        }
    else:
        mean, var = state["mean"].double(), state["var"].double()
        new_state = state
    inv = torch.rsqrt(var + eps) * params["scale"].double()
    y = _Normalize.apply(x, mean.to(x.dtype), inv.to(x.dtype),
                         params["bias"].to(x.dtype))
    return y, new_state


def make_rmsnorm_spec(dim: int, dtype=torch.float32):
    return {"scale": ParamSpec((dim,), dtype, (None,), ones_init)}


def apply_rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6,
                  exact: bool = False) -> torch.Tensor:
    """RMS norm in float32, returned in ``x``'s dtype. ``exact``: the mean
    square is summed in float64 and rounded once, so a row's norm does not
    depend on the rows beside it (`QuantConfig.batch_invariant`)."""
    xf = x.float()
    if exact:
        var = (x.double() ** 2).mean(dim=-1, keepdim=True).float()
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def make_layernorm_spec(dim: int, dtype=torch.float32, *,
                        parametric: bool = True):
    if not parametric:
        return {}
    return {"scale": ParamSpec((dim,), dtype, (None,), ones_init),
            "bias": ParamSpec((dim,), dtype, (None,), zeros_init)}


def apply_layernorm(params, x: torch.Tensor, *, eps: float = 1e-5,
                    exact: bool = False) -> torch.Tensor:
    """LayerNorm in float32; with empty params this is OLMo's
    non-parametric LN. ``exact``: mean and variance are summed in float64
    and rounded once, as in `apply_rmsnorm`."""
    xf = x.float()
    if exact:
        xd = x.double()
        mean_d = xd.mean(dim=-1, keepdim=True)
        mean = mean_d.float()
        var = ((xd - mean_d) ** 2).mean(dim=-1, keepdim=True).float()
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if params:
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------- embed


def make_embed_spec(vocab: int, dim: int, *, dtype=torch.float32,
                    axes: Tuple[Optional[str], Optional[str]] = ("vocab",
                                                                 "embed")):
    return {"table": ParamSpec((vocab, dim), dtype, axes, normal_init(1.0))}


def apply_embed(params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids.long()]


def apply_unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied read-out: logits = x @ table^T."""
    return torch.matmul(x, params["table"].to(x.dtype).T)


# --------------------------------------------------------------------- misc


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, as the JAX package's ``jax.nn.gelu(approximate=True)``
    (torch's default is the erf form)."""
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------- pools


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max pool over H and W of an NHWC (or (B, H, W, n, C))
    tensor."""
    if x.ndim == 5:
        return max_pool(x.flatten(3), window, stride).unflatten(3,
                                                                x.shape[3:])
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, summed in float64 and rounded once (see
    `apply_batchnorm`); (B, H, W, n, C) gives (B, n, C)."""
    return x.mean(dim=(1, 2), dtype=torch.float64).to(x.dtype)
