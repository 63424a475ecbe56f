"""Transformer block assembly: norms + mixer (attn/local/rglru/ssm) + FFN
(port of `repro.nn.transformer`).

A *block* is one residual layer of the network. `make_block_spec` /
`apply_block` / `apply_block_decode` dispatch on the block type string; the
LM assembler (`repro_torch.models.lm`) stacks same-typed blocks over a
leading layer axis and walks it. Block types ``attn``, ``local``,
``rglru`` (Griffin's recurrent mixer, then the FFN) and ``ssm`` (Mamba-2's
SSD mixer alone: no ``ln2``, no FFN) are ported; an attention block of a
MoE config holds the MoE FFN (``moe``, `repro_torch.nn.moe`) in place of
the dense one, and its prefill returns the MoE's load-balance and z losses
as its aux. A block built with
``cross_attn`` (the encoder-decoder family's decoder) attends over the
encoder output between its mixer and its FFN (``ln_x``, ``xattn``: keys and
values projected from the encoder output, no RoPE; in decode, read from the
cache's ``xk``/``xv``); ``encoder=True`` runs an ``attn`` block as the
encoder's (non-causal, no RoPE). ``apply_block_chunk`` is the serving
engine's chunked prefill through one block; a recurrent mixer there runs the
whole prompt from its zero state (the engine gives recurrent models
single-chunk plans); cross-attention has no chunk path and raises, as in
the JAX package.

Every compressible matmul takes an optional ``w_eff``: {"attn/wq": the
fake-quantized weight, ...}, computed for all layers at once by the
model's one grouped K3 launch; a block called alone fake-quantizes its own.
In a meshed step ``tp`` names the sub-modules that compute this rank's
share of their features (`apply_block`): attention, cross-attention, the
FFN, the MoE and the recurrent mixers; the norms compute whole.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.export import serve_dense
from repro_torch.distributed.sharding import copy_to_model, read_as
from repro_torch.models.config import ArchConfig
from repro_torch.nn import attention as A
from repro_torch.nn import moe as MOE
from repro_torch.nn import rglru as RG
from repro_torch.nn import ssm as SSM
from repro_torch.nn.layers import (
    ACTIVATIONS,
    QuantConfig,
    apply_layernorm,
    apply_rmsnorm,
    lm_fake_quant_act,
    quantized_mm,
)
from repro_torch.nn.spec import ParamSpec, fan_in_init, ones_init, zeros_init

# the compressible matmuls of a block, by sub-module, in
# `lm_compress.ELIGIBLE`'s order (the JAX package's `_project`,
# `apply_ffn` and the mixers' `quantized_mm` fake-quantize exactly these
# under QAT)
MATMULS = {"attn": ("wq", "wk", "wv", "wo"),
           "xattn": ("wq", "wk", "wv", "wo"),
           "mlp": ("w_gate", "w_up", "w_down"),
           "moe": ("w_gate", "w_up", "w_down",
                   "shared_gate", "shared_up", "shared_down"),
           "ssm": ("in_proj", "out_proj"),
           "rglru": ("in_proj", "gate_proj", "w_a", "w_x", "out_proj")}
MIXERS = ("attn", "local", "rglru", "ssm")
RECURRENT = ("rglru", "ssm")

def block_matmuls(block_params) -> list:
    """["attn/wq", ..., "mlp/w_down"]: the compressible matmul weights a
    block's parameters hold, in `MATMULS` order."""
    return [f"{sub}/{key}" for sub, keys in MATMULS.items()
            if sub in block_params for key in keys if key in block_params[sub]]


# ------------------------------------------------------------------- norms


def make_norm_spec(cfg: ArchConfig):
    if cfg.norm == "rmsnorm":
        return {"scale": ParamSpec((cfg.d_model,), cfg.pdtype, (None,),
                                   ones_init)}
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((cfg.d_model,), cfg.pdtype, (None,),
                                   ones_init),
                "bias": ParamSpec((cfg.d_model,), cfg.pdtype, (None,),
                                  zeros_init)}
    if cfg.norm == "nonparam_ln":
        return {}
    raise ValueError(cfg.norm)


def apply_norm(params, x, cfg: ArchConfig, exact: bool = False):
    """The architecture's norm; ``exact``: statistics summed in float64
    (`QuantConfig.batch_invariant`)."""
    if cfg.norm == "rmsnorm":
        return apply_rmsnorm(params, x, exact=exact)
    # parametric or non-parametric LN
    return apply_layernorm(params, x, exact=exact)


# ------------------------------------------------------------------- ffn


def make_ffn_spec(cfg: ArchConfig):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    spec = {
        "w_up": ParamSpec((d, f), dt, ("embed", "mlp"),
                          fan_in_init(in_axis=0)),
        "w_down": ParamSpec((f, d), dt, ("mlp", "embed"),
                            fan_in_init(in_axis=0)),
    }
    if cfg.ffn in ("swiglu", "geglu"):
        spec = {"w_gate": ParamSpec((d, f), dt, ("embed", "mlp"),
                                    fan_in_init(in_axis=0)), **spec}
    return spec


def apply_ffn(params, x, cfg: ArchConfig, *,
              qcfg: QuantConfig = QuantConfig.off(), comp=None,
              name: str = "mlp", w_eff=None, tp=None):
    """SwiGLU / GeGLU / GELU FFN. On the serve path each matmul runs on the
    packed LUT GEMM with its activation fused into the kernel's epilogue
    (the gate's SiLU); under QAT the products are correctly rounded
    (`exact_matmul`), so the two agree to float32 ulps. ``tp`` (a
    `repro_torch.distributed.sharding.ModelSplit`): the weights are this
    rank's share of the hidden width, w_gate / w_up column-parallel (on
    one `copy_to_model` copy of their input) and w_down row-parallel; the
    hidden activation's amax is taken over the model ranks too."""

    def mm(key, xin, activation="none"):
        """act(xin @ w[key])."""
        unit = f"{name}/{key}"
        c = None if comp is None else comp.get(unit)
        art = None if c is None else c.get("serve")
        if qcfg.enabled and qcfg.comp_mode == "serve" and art is not None:
            return serve_dense(xin, art, activation=activation)
        split = None if tp is None else (
            tp, "row" if key == "w_down" else "column")
        y = quantized_mm(params, key, xin, qcfg=qcfg, comp=comp, name=name,
                         dtype=x.dtype, w_eff=None if w_eff is None
                         else w_eff.get(unit), tp=split)
        return ACTIVATIONS[activation](y)

    xin = lm_fake_quant_act(x, qcfg)
    if tp is not None:
        xin = read_as(xin, copy_to_model(
            x, tp, qcfg.enabled or qcfg.batch_invariant))
    if cfg.ffn in ("swiglu", "geglu"):
        act = "silu" if cfg.ffn == "swiglu" else "gelu"
        h = mm("w_gate", xin, act) * mm("w_up", xin)
    else:
        h = mm("w_up", xin, "gelu")
    h = lm_fake_quant_act(h, qcfg, tp)
    return mm("w_down", h)


# ------------------------------------------------------------------- blocks


def make_block_spec(cfg: ArchConfig, block_type: str, *,
                    cross_attn: bool = False):
    if block_type not in MIXERS:
        raise ValueError(block_type)
    spec = {"ln1": make_norm_spec(cfg)}
    if block_type == "ssm":
        spec["ssm"] = SSM.make_ssm_spec(cfg.ssm_dims(), cfg.pdtype)
    else:
        if block_type == "rglru":
            spec["rglru"] = RG.make_rglru_spec(cfg.rglru_dims(), cfg.pdtype)
        else:
            spec["attn"] = A.make_attention_spec(
                cfg.attn_dims(block_type == "local"), cfg.pdtype)
        spec["ln2"] = make_norm_spec(cfg)
        if cfg.is_moe and block_type != "rglru":
            spec["moe"] = MOE.make_moe_spec(cfg.moe_dims(), cfg.pdtype)
        else:
            spec["mlp"] = make_ffn_spec(cfg)
    if cross_attn:
        spec["ln_x"] = make_norm_spec(cfg)
        spec["xattn"] = A.make_attention_spec(cfg.enc_attn_dims(),
                                              cfg.pdtype)
    return spec


def _check_block(params, block_type: str) -> None:
    if block_type not in MIXERS:
        raise ValueError(block_type)


def _ffn_half(params, x, cfg, qcfg, comp, w_eff, tp=None):
    """``(x + ffn(ln2(x)), MoE aux or None)``: the second half of every
    block but ``ssm``, the dense FFN or the MoE (``tp``: the block's
    splits, `apply_block`'s)."""
    tp = tp or {}
    h = apply_norm(params["ln2"], x, cfg, qcfg.batch_invariant)
    if "moe" in params:
        y, aux = MOE.apply_moe(params["moe"], h, cfg.moe_dims(), qcfg=qcfg,
                               comp=comp, name="moe", w_eff=w_eff,
                               tp=tp.get("moe"))
        return x + y, aux
    return x + apply_ffn(params["mlp"], h, cfg, qcfg=qcfg, comp=comp,
                         name="mlp", w_eff=w_eff, tp=tp.get("mlp")), None


def _cross_kv(attn_params, enc_out, qcfg, comp, w_eff, dims, tp=None):
    """Cross-attention K/V (B, S_enc, Hkv, D) from the encoder output (no
    RoPE). ``tp``: the K/V heads this rank's query heads read, wk/wv
    column-parallel on one `copy_to_model` copy of the encoder output."""
    sel = A._kv_select(tp, dims, attn_params["wk"])
    shared = A._shared_input(enc_out, tp, qcfg)
    return tuple(A._project(attn_params, enc_out, qcfg, comp, "xattn", key,
                            bias, w_eff, tp, sel, shared)
                 for key, bias in (("wk", "bk"), ("wv", "bv")))


def _cross_half(params, x, cfg, qcfg, comp, w_eff, enc_out, q_block,
                kv_block, tp=None):
    """``x + xattn(ln_x(x), enc_out)`` and the cross K/V it used (None, x
    for a block without cross-attention). ``tp``: this rank's heads."""
    if "xattn" not in params:
        return x, None
    if enc_out is None:
        raise ValueError("a cross-attention block needs the encoder output "
                         "(enc_embeds)")
    h = apply_norm(params["ln_x"], x, cfg, qcfg.batch_invariant)
    dims = cfg.enc_attn_dims()
    kv = _cross_kv(params["xattn"], enc_out, qcfg, comp, w_eff, dims, tp)
    xa = A.apply_attention(params["xattn"], h, dims, qcfg=qcfg, comp=comp,
                           name="xattn", kv=kv, q_block=q_block,
                           kv_block=kv_block, w_eff=w_eff, tp=tp)
    return x + xa, kv


def _recurrent_prefill(params, h, cfg, block_type, qcfg, comp, w_eff,
                       return_state, tp=None):
    """A recurrent mixer over the whole sequence from its zero state:
    output, or (output, decode-cache state) with ``return_state``. ``tp``:
    the mixer's split (`apply_block`'s ``tp[block_type]``)."""
    if block_type == "rglru":
        return RG.apply_rglru(params["rglru"], h, cfg.rglru_dims(),
                              qcfg=qcfg, comp=comp, name="rglru",
                              return_state=return_state, w_eff=w_eff, tp=tp)
    return SSM.apply_ssm(params["ssm"], h, cfg.ssm_dims(), qcfg=qcfg,
                         comp=comp, name="ssm", return_state=return_state,
                         w_eff=w_eff, tp=tp)


def apply_block(params, x: torch.Tensor, cfg: ArchConfig, block_type: str, *,
                positions: Optional[torch.Tensor] = None,
                qcfg: QuantConfig = QuantConfig.off(), comp=None,
                enc_out: Optional[torch.Tensor] = None,
                q_block: int = 512, kv_block: int = 512,
                encoder: bool = False, return_state: bool = False,
                w_eff=None, use_flash: bool = False, tp=None):
    """One residual block (prefill). Returns (x, aux), or ((x, aux), state)
    when ``return_state``: the state is the block's contribution to a
    decode cache (K/V after RoPE, or the recurrent mixer's final state; a
    cross-attention block adds its cross K/V as ``xk``/``xv``).
    ``enc_out``: the encoder output a cross-attention block attends over.
    ``encoder``: the encoder's self-attention (non-causal, no RoPE).
    ``use_flash``: the attention's flash backward (`repro_torch.nn.flash`).
    ``tp``: {"attn": split, "xattn": split, "mlp": split, "ssm": split,
    "rglru": split, "moe": {"experts": split, ...}}, the sub-modules that
    compute this rank's share of their heads, hidden width, channels or
    experts (a meshed step's tensor-parallel units,
    `repro_torch.distributed.sharding.LayerGather.block_splits`); one left
    out computes whole. The norms compute whole."""
    _check_block(params, block_type)
    tp = tp or {}
    aux = {"lb_loss": torch.zeros((), device=x.device),
           "z_loss": torch.zeros((), device=x.device)}
    h = apply_norm(params["ln1"], x, cfg, qcfg.batch_invariant)
    state = None
    if block_type in RECURRENT:
        mix = _recurrent_prefill(params, h, cfg, block_type, qcfg, comp,
                                 w_eff, return_state, tp.get(block_type))
        if return_state:
            mix, state = mix
    else:
        dims = cfg.enc_attn_dims() if encoder \
            else cfg.attn_dims(block_type == "local")
        mix = A.apply_attention(params["attn"], h, dims,
                                positions=positions, qcfg=qcfg, comp=comp,
                                name="attn", q_block=q_block,
                                kv_block=kv_block, return_kv=return_state,
                                w_eff=w_eff, use_flash=use_flash,
                                tp=tp.get("attn"))
        if return_state:
            mix, (k_st, v_st) = mix
            state = {"k": k_st, "v": v_st}
    x = x + mix
    x, kv = _cross_half(params, x, cfg, qcfg, comp, w_eff, enc_out, q_block,
                        kv_block, tp.get("xattn"))
    if return_state and kv is not None:
        state = {**state, "xk": kv[0], "xv": kv[1]}
    if block_type != "ssm":
        x, moe_aux = _ffn_half(params, x, cfg, qcfg, comp, w_eff, tp)
        if moe_aux is not None:
            aux = {"lb_loss": moe_aux["lb_loss"],
                   "z_loss": moe_aux["z_loss"]}
    return ((x, aux), state) if return_state else (x, aux)


# ------------------------------------------------------------------- decode


def block_cache_spec(cfg: ArchConfig, block_type: str, batch: int,
                     max_len: int, dtype=torch.bfloat16, *,
                     cross_len: int = 0):
    """Shape-and-dtype placeholders (meta tensors) of a block's cache; the
    recurrent mixers' states are float32 whatever ``dtype``. ``cross_len``:
    an attention block's cross-attention K/V ``xk``/``xv`` (B, cross_len,
    Hkv, D) in ``dtype``."""
    if block_type == "rglru":
        return RG.rglru_cache_spec(batch, cfg.rglru_dims(), torch.float32)
    if block_type == "ssm":
        return SSM.ssm_cache_spec(batch, cfg.ssm_dims(), torch.float32)
    if block_type not in MIXERS:
        raise ValueError(block_type)
    dims = cfg.attn_dims(block_type == "local")
    cache_len = min(max_len, dims.window) if dims.window else max_len
    spec = A.kv_cache_spec(batch, cache_len, dims, dtype)
    if cross_len:
        xdims = cfg.enc_attn_dims()
        shape = (batch, cross_len, xdims.n_kv_heads, xdims.head_dim)
        for key in ("xk", "xv"):
            spec[key] = torch.empty(shape, dtype=dtype, device="meta")
    return spec


def init_block_cache(cfg: ArchConfig, block_type: str, batch: int,
                     max_len: int, dtype=torch.bfloat16, *, device,
                     cross_len: int = 0):
    spec = block_cache_spec(cfg, block_type, batch, max_len, dtype,
                            cross_len=cross_len)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def apply_block_decode(params, x: torch.Tensor, cache: dict, pos,
                       cfg: ArchConfig, block_type: str, *,
                       qcfg: QuantConfig = QuantConfig.off(), comp=None,
                       w_eff=None, tp=None):
    """One decode step through a block: x (B, 1, d), pos () or (B,).
    Returns (x, updated cache). ``tp`` as in `apply_block`."""
    _check_block(params, block_type)
    tp = tp or {}
    h = apply_norm(params["ln1"], x, cfg, qcfg.batch_invariant)
    if block_type == "rglru":
        mix, new_cache = RG.apply_rglru_decode(
            params["rglru"], h, cache, cfg.rglru_dims(), qcfg=qcfg,
            comp=comp, name="rglru", w_eff=w_eff, tp=tp.get("rglru"))
    elif block_type == "ssm":
        mix, new_cache = SSM.apply_ssm_decode(
            params["ssm"], h, cache, cfg.ssm_dims(), qcfg=qcfg, comp=comp,
            name="ssm", w_eff=w_eff, tp=tp.get("ssm"))
    else:
        new_cache = dict(cache)
        mix, kv_new = A.apply_attention_decode(
            params["attn"], h, {"k": cache["k"], "v": cache["v"]}, pos,
            cfg.attn_dims(block_type == "local"), qcfg=qcfg, comp=comp,
            name="attn", w_eff=w_eff, tp=tp.get("attn"))
        new_cache.update(kv_new)
    x = x + mix
    if "xattn" in params:
        h = apply_norm(params["ln_x"], x, cfg, qcfg.batch_invariant)
        xa, _ = A.apply_attention_decode(
            params["xattn"], h, {}, pos, cfg.enc_attn_dims(), qcfg=qcfg,
            comp=comp, name="xattn", w_eff=w_eff,
            cross_kv=(cache["xk"], cache["xv"]), tp=tp.get("xattn"))
        x = x + xa
    if block_type != "ssm":
        x, _ = _ffn_half(params, x, cfg, qcfg, comp, w_eff, tp)
    return x, new_cache


def apply_block_chunk(params, x: torch.Tensor, cache: dict,
                      positions: torch.Tensor, cfg: ArchConfig,
                      block_type: str, *,
                      qcfg: QuantConfig = QuantConfig.off(), comp=None,
                      q_block: int = 8, kv_block: int = 8, w_eff=None):
    """One chunked-prefill step through a block: x (B, C, d), one prefill
    chunk per row at absolute ``positions`` (B, C). Returns (x, updated
    cache). The attention mixer scatters the chunk's K/V into the row's
    cache and attends over the whole cache with per-row positions
    (`attention.apply_attention_chunk`). Recurrent mixers have no
    mid-sequence state injection: the chunk must be the whole prompt from
    position 0, and the mixer runs it from its zero state (the engine
    enforces single-chunk plans for them, as the JAX package's does).
    Cross-attention has no chunk path (`ValueError`, as in the JAX
    package)."""
    if "xattn" in params:
        raise ValueError("chunked prefill does not support cross-attention "
                         "blocks; use the oneshot/wave path")
    _check_block(params, block_type)
    h = apply_norm(params["ln1"], x, cfg, qcfg.batch_invariant)
    if block_type in RECURRENT:
        mix, new_cache = _recurrent_prefill(params, h, cfg, block_type,
                                            qcfg, comp, w_eff, True)
    else:
        new_cache = dict(cache)
        mix, kv_new = A.apply_attention_chunk(
            params["attn"], h, {"k": cache["k"], "v": cache["v"]},
            positions, cfg.attn_dims(block_type == "local"), qcfg=qcfg,
            comp=comp, name="attn", q_block=q_block, kv_block=kv_block,
            w_eff=w_eff)
        new_cache.update(kv_new)
    x = x + mix
    if block_type != "ssm":
        x, _ = _ffn_half(params, x, cfg, qcfg, comp, w_eff)
    return x, new_cache
