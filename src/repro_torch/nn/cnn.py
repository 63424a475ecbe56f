"""CNN zoo: LeNet-5, ResNet-8/20 and ResNet-50 for CIFAR (port of
`repro.nn.cnn`).

Each model is a `CNNModel` bundling the param/state spec trees, an apply
function over parameter dicts, and the list of compressible layers with
their systolic matmul dimensions. Layer names, parameter paths and
`comp_layers` are the JAX package's, so plans cross-load.

``apply(params, state, x, *, train, qcfg, comp, serve, cands) ->
(logits, new_state)``; with ``capture_taps=True`` it returns ``(logits,
new_state, taps)``, taps ``{layer: {"a_int", "w_int"}}`` holding each
compressible layer's int8 input and weights (the profiler's trace inputs).

``cands=n`` runs n candidates of the model in one forward on one shared
input batch: ``params``, ``state`` and ``comp`` carry a leading candidate
axis n on every leaf (stacked, or stride-0 views of one shared tensor;
`repro_torch.core.qat.stack_pytrees` / `broadcast_pytree`), the logits
come out (B, n, classes) and the new state with the same axis. Candidate
j's logits and state are what the forward of candidate j alone computes
(`repro_torch.nn.layers` says how). One grouped K3 launch fake-quantizes
all n x layers weights; taps and serve mode take one candidate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import qat
from repro_torch.core.layer_energy import (
    MatmulDims,
    conv_matmul_dims,
    dense_matmul_dims,
)
from repro_torch.nn import layers as L
from repro_torch.nn.layers import QuantConfig


@dataclasses.dataclass(frozen=True)
class CompLayer:
    """A compressible (weight-bearing matmul) layer."""

    name: str
    kind: str                      # "conv" | "dense"
    c_in: int
    c_out: int
    kernel: int = 1                # conv kernel size (1 for dense)
    stride: int = 1
    out_hw: Tuple[int, int] = (1, 1)  # spatial dims of the *output* map
    padding: str = "SAME"

    def matmul_dims(self, batch: int = 1) -> MatmulDims:
        if self.kind == "conv":
            return conv_matmul_dims(self.c_in, self.c_out,
                                    (self.kernel, self.kernel), self.out_hw,
                                    batch)
        return dense_matmul_dims(self.c_in, self.c_out, batch)


def _weight_path(name: str) -> Tuple[str, ...]:
    """Path of compressible layer ``name``'s weight in the params tree."""
    return tuple(name.split("/")) + ("w",)


def _weight(params, name: str):
    """Compressible layer ``name``'s weight in ``params``."""
    node = params
    for k in _weight_path(name):
        node = node[k]
    return node


@dataclasses.dataclass
class CNNModel:
    name: str
    num_classes: int
    spec: dict
    state_spec: dict
    apply: Callable  # (params, state, x, *, train, qcfg, comp, serve, capture_taps, cands) -> (logits, state[, taps])
    comp_layers: List[CompLayer]

    def weight_path(self, name: str) -> Tuple[str, ...]:
        return _weight_path(name)

    def comp_layer(self, name: str) -> CompLayer:
        for cl in self.comp_layers:
            if cl.name == name:
                return cl
        raise KeyError(name)

    def get_weight(self, params, name: str):
        return _weight(params, name)


def _maybe(tree: Optional[Dict], name: str):
    return None if tree is None else tree.get(name)


def _fake_quant_all(params, names, qcfg: QuantConfig, comp, serve, cands):
    """{layer: fake-quantized weight} of the compressible layers a forward
    fake-quantizes, from one grouped call (one K3 launch on the card): every
    layer on the fake-quant path, in ``serve`` mode the layers without an
    artifact; with ``cands``, every candidate of each. None when
    quantization is off."""
    if not qcfg.enabled:
        return None
    if qcfg.comp_mode == "serve":
        names = [name for name in names if _maybe(serve, name) is None]
        if not names:
            return {}
    ws = [_weight(params, name) for name in names]
    comps = [_maybe(comp, name) for name in names]
    return dict(zip(names, qat.fake_quant_weights(ws, comps, cands)))


def _check_cands(cands, serve, capture_taps) -> None:
    if cands is not None and (serve is not None or capture_taps):
        raise ValueError("a candidate axis (cands) runs the fake-quant "
                         "forward only: no serve artifacts, no taps")


def _flatten(h: torch.Tensor, cands) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*W*C); (B, H, W, n, C) -> (B, n, H*W*C), each
    candidate in the order of its own forward."""
    if cands is None:
        return h.reshape(h.shape[0], -1)
    return h.permute(0, 3, 1, 2, 4).reshape(h.shape[0], cands, -1)


# ===================================================================== LeNet-5


def lenet5(num_classes: int = 10, in_channels: int = 3) -> CNNModel:
    """LeNet-5 for 32x32 inputs (paper: LeNet-5 / CIFAR-10)."""
    spec = {
        "conv1": L.make_conv_spec(in_channels, 6, 5),
        "conv2": L.make_conv_spec(6, 16, 5),
        "fc1": L.make_dense_spec(16 * 5 * 5, 120),
        "fc2": L.make_dense_spec(120, 84),
        "fc3": L.make_dense_spec(84, num_classes),
    }
    comp_layers = [
        CompLayer("conv1", "conv", in_channels, 6, 5, 1, (28, 28), "VALID"),
        CompLayer("conv2", "conv", 6, 16, 5, 1, (10, 10), "VALID"),
        CompLayer("fc1", "dense", 400, 120),
        CompLayer("fc2", "dense", 120, 84),
        CompLayer("fc3", "dense", 84, num_classes),
    ]
    names = [cl.name for cl in comp_layers]

    def apply(params, state, x, *, train=False, qcfg=QuantConfig.off(),
              comp=None, serve=None, capture_taps=False, cands=None):
        _check_cands(cands, serve, capture_taps)
        tap = {} if capture_taps else None
        w_eff = _fake_quant_all(params, names, qcfg, comp, serve, cands)

        def kw(name):
            return dict(qcfg=qcfg, comp=_maybe(comp, name),
                        serve_art=_maybe(serve, name), tap=tap,
                        tap_name=name, w_eff=_maybe(w_eff, name))

        # relu rides the layer epilogue: fused into the LUT-GEMM kernel on
        # the serve path, applied eagerly on the fake-quant/dense path
        h = L.apply_conv(params["conv1"], x, padding="VALID",
                         activation="relu", **kw("conv1"))
        h = L.max_pool(h)
        h = L.apply_conv(params["conv2"], h, padding="VALID",
                         activation="relu", **kw("conv2"))
        h = L.max_pool(h)
        h = _flatten(h, cands)
        h = L.apply_dense(params["fc1"], h, activation="relu", **kw("fc1"))
        h = L.apply_dense(params["fc2"], h, activation="relu", **kw("fc2"))
        logits = L.apply_dense(params["fc3"], h, **kw("fc3"))
        return (logits, state, tap) if capture_taps else (logits, state)

    return CNNModel("lenet5", num_classes, spec, {}, apply, comp_layers)


# ===================================================================== ResNets


def _basic_block_spec(c_in: int, c_out: int, stride: int):
    spec = {
        "conv1": L.make_conv_spec(c_in, c_out, 3, use_bias=False),
        "bn1": L.make_batchnorm_spec(c_out),
        "conv2": L.make_conv_spec(c_out, c_out, 3, use_bias=False),
        "bn2": L.make_batchnorm_spec(c_out),
    }
    state = {
        "bn1": L.make_batchnorm_state(c_out),
        "bn2": L.make_batchnorm_state(c_out),
    }
    if stride != 1 or c_in != c_out:
        spec["down"] = L.make_conv_spec(c_in, c_out, 1, use_bias=False)
        spec["down_bn"] = L.make_batchnorm_spec(c_out)
        state["down_bn"] = L.make_batchnorm_state(c_out)
    return spec, state


def _conv_kw(prefix, qcfg, comp, serve, tap, w_eff, name):
    full = f"{prefix}/{name}"
    return dict(qcfg=qcfg, comp=_maybe(comp, full),
                serve_art=_maybe(serve, full), tap=tap, tap_name=full,
                w_eff=_maybe(w_eff, full))


def _apply_basic_block(params, state, x, *, prefix, stride, train, qcfg, comp,
                       serve, tap, w_eff):
    kw = lambda name: _conv_kw(prefix, qcfg, comp, serve, tap, w_eff, name)  # noqa: E731
    h = L.apply_conv(params["conv1"], x, stride=stride, **kw("conv1"))
    h, s1 = L.apply_batchnorm(params["bn1"], state["bn1"], h, train=train)
    h = torch.relu(h)
    h = L.apply_conv(params["conv2"], h, **kw("conv2"))
    h, s2 = L.apply_batchnorm(params["bn2"], state["bn2"], h, train=train)
    new_state = {"bn1": s1, "bn2": s2}
    if "down" in params:
        skip = L.apply_conv(params["down"], x, stride=stride, **kw("down"))
        skip, s3 = L.apply_batchnorm(params["down_bn"], state["down_bn"],
                                     skip, train=train)
        new_state["down_bn"] = s3
    else:
        skip = x
    return torch.relu(h + skip), new_state


def _resnet_stem_spec(in_channels, width, fc_in, num_classes):
    spec = {
        "conv1": L.make_conv_spec(in_channels, width, 3, use_bias=False),
        "bn1": L.make_batchnorm_spec(width),
        "fc": L.make_dense_spec(fc_in, num_classes),
    }
    return spec, {"bn1": L.make_batchnorm_state(width)}


def _resnet_apply(block_fn, block_names, strides, comp_layers):
    """apply() of a ResNet: the compressible weights fake-quantized in one
    grouped call, stem conv + BN + relu, the blocks in order, global
    average pool, fc."""
    names = [cl.name for cl in comp_layers]

    def apply(params, state, x, *, train=False, qcfg=QuantConfig.off(),
              comp=None, serve=None, capture_taps=False, cands=None):
        _check_cands(cands, serve, capture_taps)
        tap = {} if capture_taps else None
        w_eff = _fake_quant_all(params, names, qcfg, comp, serve, cands)
        h = L.apply_conv(params["conv1"], x, qcfg=qcfg,
                         comp=_maybe(comp, "conv1"),
                         serve_art=_maybe(serve, "conv1"), tap=tap,
                         tap_name="conv1", w_eff=_maybe(w_eff, "conv1"))
        h, s0 = L.apply_batchnorm(params["bn1"], state["bn1"], h, train=train)
        h = torch.relu(h)
        new_state = {"bn1": s0}
        for name in block_names:
            h, new_state[name] = block_fn(
                params[name], state[name], h, prefix=name,
                stride=strides[name], train=train, qcfg=qcfg, comp=comp,
                serve=serve, tap=tap, w_eff=w_eff)
        h = L.avg_pool_global(h)
        logits = L.apply_dense(params["fc"], h, qcfg=qcfg,
                               comp=_maybe(comp, "fc"),
                               serve_art=_maybe(serve, "fc"), tap=tap,
                               tap_name="fc", w_eff=_maybe(w_eff, "fc"))
        return ((logits, new_state, tap) if capture_taps
                else (logits, new_state))

    return apply


def _basic_resnet(name: str, blocks_per_stage: int, num_classes: int,
                  in_channels: int) -> CNNModel:
    """CIFAR ResNet of BasicBlocks, 3 stages of widths 16/32/64."""
    widths = [16, 32, 64]
    spec, state_spec = _resnet_stem_spec(in_channels, 16, 64, num_classes)
    comp_layers = [CompLayer("conv1", "conv", in_channels, 16, 3, 1, (32, 32))]
    hw, c_in, strides = 32, 16, {}
    for si, width in enumerate(widths, start=1):
        for bi in range(1, blocks_per_stage + 1):
            stride = 2 if (si > 1 and bi == 1) else 1
            if stride == 2:
                hw //= 2
            name = f"s{si}b{bi}"
            spec[name], state_spec[name] = _basic_block_spec(c_in, width,
                                                             stride)
            strides[name] = stride
            comp_layers.append(CompLayer(f"{name}/conv1", "conv", c_in, width,
                                         3, stride, (hw, hw)))
            comp_layers.append(CompLayer(f"{name}/conv2", "conv", width, width,
                                         3, 1, (hw, hw)))
            if stride != 1 or c_in != width:
                comp_layers.append(CompLayer(f"{name}/down", "conv", c_in,
                                             width, 1, stride, (hw, hw)))
            c_in = width
    comp_layers.append(CompLayer("fc", "dense", 64, num_classes))
    apply = _resnet_apply(_apply_basic_block, list(strides), strides,
                          comp_layers)
    return CNNModel(name, num_classes, spec, state_spec, apply, comp_layers)


def resnet20(num_classes: int = 10, in_channels: int = 3) -> CNNModel:
    """CIFAR ResNet-20: 3 stages x 3 BasicBlocks, widths 16/32/64."""
    return _basic_resnet("resnet20", 3, num_classes, in_channels)


def resnet8(num_classes: int = 10, in_channels: int = 3) -> CNNModel:
    """3-stage x 1-block reduced ResNet (same family as resnet20)."""
    return _basic_resnet("resnet8", 1, num_classes, in_channels)


def _bottleneck_spec(c_in: int, width: int, stride: int):
    c_out = width * 4
    spec = {
        "conv1": L.make_conv_spec(c_in, width, 1, use_bias=False),
        "bn1": L.make_batchnorm_spec(width),
        "conv2": L.make_conv_spec(width, width, 3, use_bias=False),
        "bn2": L.make_batchnorm_spec(width),
        "conv3": L.make_conv_spec(width, c_out, 1, use_bias=False),
        "bn3": L.make_batchnorm_spec(c_out),
    }
    state = {
        "bn1": L.make_batchnorm_state(width),
        "bn2": L.make_batchnorm_state(width),
        "bn3": L.make_batchnorm_state(c_out),
    }
    if stride != 1 or c_in != c_out:
        spec["down"] = L.make_conv_spec(c_in, c_out, 1, use_bias=False)
        spec["down_bn"] = L.make_batchnorm_spec(c_out)
        state["down_bn"] = L.make_batchnorm_state(c_out)
    return spec, state


def _apply_bottleneck(params, state, x, *, prefix, stride, train, qcfg, comp,
                      serve, tap, w_eff):
    kw = lambda name: _conv_kw(prefix, qcfg, comp, serve, tap, w_eff, name)  # noqa: E731
    h = L.apply_conv(params["conv1"], x, **kw("conv1"))
    h, s1 = L.apply_batchnorm(params["bn1"], state["bn1"], h, train=train)
    h = torch.relu(h)
    h = L.apply_conv(params["conv2"], h, stride=stride, **kw("conv2"))
    h, s2 = L.apply_batchnorm(params["bn2"], state["bn2"], h, train=train)
    h = torch.relu(h)
    h = L.apply_conv(params["conv3"], h, **kw("conv3"))
    h, s3 = L.apply_batchnorm(params["bn3"], state["bn3"], h, train=train)
    new_state = {"bn1": s1, "bn2": s2, "bn3": s3}
    if "down" in params:
        skip = L.apply_conv(params["down"], x, stride=stride, **kw("down"))
        skip, s4 = L.apply_batchnorm(params["down_bn"], state["down_bn"],
                                     skip, train=train)
        new_state["down_bn"] = s4
    else:
        skip = x
    return torch.relu(h + skip), new_state


def resnet50(num_classes: int = 100, in_channels: int = 3) -> CNNModel:
    """ResNet-50 adapted to CIFAR (3x3 stem, no max-pool), 4 bottleneck stages."""
    stage_blocks = [3, 4, 6, 3]
    stage_widths = [64, 128, 256, 512]
    spec, state_spec = _resnet_stem_spec(in_channels, 64, 2048, num_classes)
    comp_layers = [CompLayer("conv1", "conv", in_channels, 64, 3, 1, (32, 32))]
    hw, c_in, strides = 32, 64, {}
    for si, (n_blocks, width) in enumerate(zip(stage_blocks, stage_widths),
                                           start=1):
        for bi in range(1, n_blocks + 1):
            stride = 2 if (si > 1 and bi == 1) else 1
            if stride == 2:
                hw //= 2
            name = f"s{si}b{bi}"
            spec[name], state_spec[name] = _bottleneck_spec(c_in, width,
                                                            stride)
            strides[name] = stride
            in_hw = hw * stride if stride == 2 else hw
            comp_layers.append(CompLayer(f"{name}/conv1", "conv", c_in, width,
                                         1, 1, (in_hw, in_hw)))
            comp_layers.append(CompLayer(f"{name}/conv2", "conv", width, width,
                                         3, stride, (hw, hw)))
            comp_layers.append(CompLayer(f"{name}/conv3", "conv", width,
                                         width * 4, 1, 1, (hw, hw)))
            if stride != 1 or c_in != width * 4:
                comp_layers.append(CompLayer(f"{name}/down", "conv", c_in,
                                             width * 4, 1, stride, (hw, hw)))
            c_in = width * 4
    comp_layers.append(CompLayer("fc", "dense", 2048, num_classes))
    apply = _resnet_apply(_apply_bottleneck, list(strides), strides,
                          comp_layers)
    return CNNModel("resnet50", num_classes, spec, state_spec, apply,
                    comp_layers)


CNN_FACTORIES = {"lenet5": lenet5, "resnet8": resnet8, "resnet20": resnet20,
                 "resnet50": resnet50}
