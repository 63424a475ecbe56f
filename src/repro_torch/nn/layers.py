"""Layer library: compressible Dense/Conv, batch norm and pools (port of the
CNN part of `repro.nn.layers`).

Every layer is a (make_*_spec, apply_*) pair over plain parameter dicts.
Layouts are the JAX package's: activations NHWC, conv kernels HWIO, dense
weights (in, out). Compressible layers accept an optional per-layer
compression state (`repro_torch.core.qat.CompState`) and a `QuantConfig`,
and an optional ``w_eff``: the layer's weight already fake-quantized by the
model's one grouped call (`repro_torch.core.qat.fake_quant_weights`), in
place of the layer's own `repro_torch.core.qat.fake_quant_weight`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import qat
from repro_torch.core.export import serve_conv, serve_dense
from repro_torch.core.stats import same_pad_nhwc
from repro_torch.kernels.lut_matmul.ref import ACTIVATIONS, exact_matmul
from repro_torch.nn.spec import ParamSpec, fan_in_init, ones_init, zeros_init

__all__ = [
    "ACTIVATIONS", "QuantConfig", "apply_batchnorm", "apply_conv",
    "apply_dense", "avg_pool_global", "make_batchnorm_spec",
    "make_batchnorm_state", "make_conv_spec", "make_dense_spec", "max_pool",
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
    """

    enabled: bool = False
    act_quant: bool = True
    comp_mode: str = "fake_quant"
    use_ref_kernel: bool = False

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


def _serves(qcfg: QuantConfig, serve_art) -> bool:
    return qcfg.enabled and qcfg.comp_mode == "serve" and serve_art is not None


def _record_tap(tap, tap_name, x, w, comp):
    """Profiling tap: int8 views of what sits in the MAC registers. Recorded
    on both the fake-quant and serve paths (the served weights dequantize to
    the same integers the tap reports)."""
    if tap is not None and tap_name is not None:
        tap[tap_name] = {"a_int": qat.quantize_act_int(x),
                         "w_int": qat.quantize_weight_int(w, comp)}


def _epilogue(y, params, activation, residual):
    if "b" in params:
        y = y + params["b"].to(y.dtype)
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
    ``w_eff``: the fake-quantized weight, where the caller computed it."""
    w = params["w"]
    if qcfg.enabled and qcfg.act_quant:
        x = qat.fake_quant_act(x)
    _record_tap(tap, tap_name, x, w, comp)
    if _serves(qcfg, serve_art):
        return serve_dense(x, serve_art, bias=params.get("b"),
                           residual=residual, activation=activation)
    if w_eff is None:
        w_eff = qat.fake_quant_weight(w, comp) if qcfg.enabled else w
    y = exact_matmul(x, w_eff).to(x.dtype)
    return _epilogue(y, params, activation, residual)


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

    SAME pads explicitly (`same_pad_nhwc`): torch's ``padding="same"``
    rejects stride > 1 and pads stride-2 convs differently."""
    kh, kw = w.shape[:2]
    if padding == "SAME":
        x = same_pad_nhwc(x, (kh, kw), stride)
    elif padding != "VALID":
        raise ValueError(padding)
    y = F.conv2d(x.permute(0, 3, 1, 2).double(),
                 w.permute(3, 2, 0, 1).double(), stride=stride)
    return y.permute(0, 2, 3, 1).to(x.dtype)


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
    ``w_eff``: the fake-quantized weight, where the caller computed it."""
    w = params["w"]
    if qcfg.enabled and qcfg.act_quant:
        x = qat.fake_quant_act(x)
    _record_tap(tap, tap_name, x, w, comp)
    if _serves(qcfg, serve_art):
        return serve_conv(x, serve_art, stride=stride, padding=padding,
                          bias=params.get("b"), residual=residual,
                          activation=activation)
    if w_eff is None:
        w_eff = qat.fake_quant_weight(w, comp) if qcfg.enabled else w
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
    """Returns (y, new_state). Reduces over all axes but the channel (last).

    The batch statistics and the per-channel ``rsqrt(var + eps) * scale``
    are computed in float64 and rounded once; the normalisation itself is
    float32, elementwise. Float32 reductions and ``rsqrt`` differ in the
    last bit between the CPU and the card, and at depth such a bit moves an
    activation across a `fake_quant_act` rounding boundary; so the forward
    gives the same bits on both, like the convolutions (`conv_nhwc`). In
    train mode the running state is detached from the graph (the JAX
    package's state output carries no gradient; here it would chain every
    step's graph)."""
    reduce_axes = tuple(range(x.ndim - 1))
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
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype) + params["bias"].to(x.dtype)
    return y, new_state


# --------------------------------------------------------------------- pools


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max pool over H and W of an NHWC tensor."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, summed in float64 and rounded once (see
    `apply_batchnorm`)."""
    return x.mean(dim=(1, 2), dtype=torch.float64).to(x.dtype)
