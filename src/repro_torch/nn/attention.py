"""Attention: GQA/MQA/MHA + RoPE + sliding window + KV cache (port of
`repro.nn.attention`).

Prefill runs the JAX package's double-blocked online-softmax schedule
(`blocked_attention`: query blocks, and inside each a walk over key/value
blocks with a running maximum and sum, in float32), so its results follow
the reference's rounding; the scores and the probability-weighted values
are plain `torch.matmul` products in the activations' dtype (not quantized
products: no kernel of the TPU path computes them). Decode is one query
against the cache. Query heads are grouped over the K/V heads as
``(B, S, Hkv, G, D)``, as in the reference. With ``exact`` (the serving
engine's `QuantConfig.batch_invariant`) the scores and the weighted values
are correctly rounded products (`exact_matmul`) and the softmax sums
float64 sums rounded once, so a row's attention does not depend on how
many rows the call holds.

The projections are compressible units: they take the same
(``qcfg``, ``comp``) pair as the dense layers. On the serve path a unit with
a `ServeArtifact` runs on the packed LUT GEMM (K2); under QAT its weight is
fake-quantized (``w_eff``: the model's one grouped K3 launch computed it)
and the product is correctly rounded (`exact_matmul`), so the two paths
agree to float32 ulps. ``apply_attention_chunk`` is the serving engine's
chunked prefill: one chunk of each row's prompt written into that row's
cache, then attended over the whole cache with per-row positions.

Cross-attention (the encoder-decoder family): `apply_attention` takes the
keys and values from ``kv`` (the encoder output's projections), and
`apply_attention_decode` attends one query over ``cross_kv``; in a meshed
step both split by heads as self-attention does (``tp``). Keys are
padded to a multiple of the key block as in the JAX package. Its
non-causal mask (the encoder's self-attention, cross-attention) masks
nothing, so the padded keys, zeros, take part in the softmax with score 0
exactly as they do in the reference; decode over an unpadded ``cross_kv``
has none, so prefill + decode equals the full forward only when the
encoder length is a multiple of the key block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import qat
from repro_torch.core.export import serve_dense
from repro_torch.distributed.sharding import (
    copy_to_model,
    read_as,
    tp_matmul,
)
from repro_torch.kernels.lut_matmul.ref import exact_matmul
from repro_torch.nn.layers import QuantConfig, lm_fake_quant_act
from repro_torch.nn.spec import ParamSpec, fan_in_init, zeros_init

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0          # 0 => full attention; > 0 => sliding window
    causal: bool = True
    softcap: float = 0.0     # attention logit softcap (gemma-style), 0 = off


def make_attention_spec(dims: AttnDims, dtype=torch.float32) -> dict:
    d, hq, hkv, hd = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    spec = {
        "wq": ParamSpec((d, hq, hd), dtype, ("embed", "heads", None),
                        fan_in_init(in_axis=0)),
        "wk": ParamSpec((d, hkv, hd), dtype, ("embed", "kv_heads", None),
                        fan_in_init(in_axis=0)),
        "wv": ParamSpec((d, hkv, hd), dtype, ("embed", "kv_heads", None),
                        fan_in_init(in_axis=0)),
        "wo": ParamSpec((hq, hd, d), dtype, ("heads", None, "embed"),
                        fan_in_init(in_axis=0)),
    }
    if dims.qkv_bias:
        spec["bq"] = ParamSpec((hq, hd), dtype, ("heads", None), zeros_init)
        spec["bk"] = ParamSpec((hkv, hd), dtype, ("kv_heads", None),
                               zeros_init)
        spec["bv"] = ParamSpec((hkv, hd), dtype, ("kv_heads", None),
                               zeros_init)
    return spec


# ----------------------------------------------------------------------- rope


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) int. Rotates the first and second
    halves of the head dimension (not interleaved pairs), in float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (D/2,)
    angles = positions[..., None].float() * freqs               # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x.float().chunk(2, dim=-1)
    out = torch.cat([xf1 * cos - xf2 * sin, xf1 * sin + xf2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ projections


def _project(params, x, qcfg: QuantConfig, comp, name: str, key: str,
             bias_key: Optional[str] = None, w_eff=None, tp=None,
             kv_select: Optional[slice] = None,
             shared: Optional[torch.Tensor] = None):
    """One projection: wq/wk/wv ``(B, S, d) -> (B, S, H, hd)`` (served
    ``in_first`` as (d, H*hd)), wo ``(B, S, H, hd) -> (B, S, d)`` (served
    ``out_last`` as (H*hd, d)). ``w_eff``: {"attn/wq": fake-quantized
    weight, ...} where the caller computed them. ``tp`` (a
    `repro_torch.distributed.sharding.ModelSplit`): the weight is this
    rank's heads, wq/wk/wv column-parallel and wo row-parallel
    (`tp_matmul`); ``shared``: wq/wk/wv's `copy_to_model` copy of ``x``,
    which the column products read (`_shared_input`); ``kv_select``: the
    K/V heads of a whole wk/wv (and bk/bv) that this rank's query heads
    read, the weight's gradient summed over the model ranks
    (`copy_to_model`)."""
    w = params[key]                        # (d, H, hd) or (H, hd, d)
    unit = f"{name}/{key}"
    c = None if comp is None else comp.get(unit)
    x = lm_fake_quant_act(x, qcfg, tp if key == "wo" else None)
    art = None if c is None else c.get("serve")
    bias = params.get(bias_key) if bias_key else None
    if key == "wo":
        x = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if qcfg.enabled and qcfg.comp_mode == "serve" and art is not None:
        if key == "wo":
            return serve_dense(x, art)
        y = serve_dense(x, art,
                        bias=None if bias is None else bias.reshape(-1))
        return y.reshape(*x.shape[:-1], w.shape[1], w.shape[2])
    if qcfg.enabled:
        w = w_eff[unit] if w_eff is not None and unit in w_eff \
            else qat.fake_quant_weights([w], [c])[0]
    if kv_select is not None:
        w = copy_to_model(w, tp)[:, kv_select]
        if bias is not None:
            bias = copy_to_model(bias, tp)[kv_select]
    w_mat = (w.reshape(-1, w.shape[-1]) if key == "wo"
             else w.reshape(w.shape[0], -1)).to(x.dtype)
    exact = qcfg.enabled or qcfg.batch_invariant
    if tp is not None:
        y = (tp_matmul(x, w_mat, tp, "row", exact) if key == "wo"
             else tp_matmul(read_as(x, shared), w_mat, tp, "column",
                            exact)).to(x.dtype)
    else:
        y = (exact_matmul(x, w_mat) if exact
             else torch.matmul(x, w_mat)).to(x.dtype)
    if key != "wo":
        y = y.reshape(*x.shape[:-1], w.shape[1], w.shape[2])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _shared_input(x, tp, qcfg: QuantConfig) -> Optional[torch.Tensor]:
    """The `copy_to_model` copy of a tensor-parallel attention's input
    that its column products read (float64 where they are correctly
    rounded: their input gradients summed once, then rounded); None
    without ``tp``."""
    if tp is None:
        return None
    return copy_to_model(x, tp, qcfg.enabled or qcfg.batch_invariant)


def _kv_select(tp, dims: AttnDims, wk) -> Optional[slice]:
    """The K/V heads that this rank's query heads read where wk holds every
    K/V head (the guard replicated kv_heads over the model ranks); None
    where wk is already this rank's share (or there is no split)."""
    if tp is None or wk.shape[1] != dims.n_kv_heads or tp.size == 1:
        return None
    hq, q0 = tp.chunk(dims.n_heads)
    g = dims.n_heads // dims.n_kv_heads
    if hq % g and g % hq:
        raise ValueError(f"{hq} query heads a rank do not group onto "
                         f"{dims.n_kv_heads} K/V heads ({g} a K/V head)")
    return slice(q0 // g, (q0 + hq - 1) // g + 1)


# ------------------------------------------------------------ blocked attention


def _block_mask(q_pos, k_pos, dims: AttnDims):
    """Boolean mask for one (q-block, k-block) pair.

    Positions are ``(Sq,)``/``(Sk,)`` (shared across the batch) or
    ``(B, Sq)``/``(B, Sk)`` (per sequence); the mask is ``(Sq, Sk)`` or
    ``(B, Sq, Sk)``.
    """
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=qp.device)
    if dims.causal:
        m &= kp <= qp
    if dims.window > 0:
        m &= kp > qp - dims.window
    return m


def _scores(a: torch.Tensor, b: torch.Tensor, exact: bool) -> torch.Tensor:
    """``a @ b`` in float32: correctly rounded when ``exact``, else a plain
    product in the operands' dtype."""
    return exact_matmul(a, b) if exact else torch.matmul(a, b).float()


def _row_sum(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """The sum over the last axis, from float64 and rounded once when
    ``exact``."""
    if exact:
        return x.sum(dim=-1, dtype=torch.float64).float()
    return x.sum(dim=-1)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dims: AttnDims, *, q_offset: int = 0,
                      q_block: int = 512, kv_block: int = 512,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None,
                      exact: bool = False,
                      use_flash: bool = False) -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D),
    Sq and Sk multiples of the block sizes (callers pad).

    GQA reshapes the queries to (B, S, Hkv, G, D). Each query block walks
    the key/value blocks in order with a running maximum, sum and output in
    float32 (the JAX package's ``lax.scan`` schedule, written as loops);
    fully masked key blocks add exactly zero once a real key has been seen.
    ``use_flash`` takes the same forward through `repro_torch.nn.flash`,
    whose backward recomputes the score tiles instead of saving them
    (per-sequence positions raise; a softcap keeps the autograd path, as in
    the JAX package). ``exact``: products and sums round once from float64
    (see the module docstring).
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if sq % q_block or sk % kv_block:
        raise ValueError(f"sequence lengths {(sq, sk)} are not multiples of "
                         f"the blocks {(q_block, kv_block)}")
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, hd)
    if q_positions is None:
        q_positions = q_offset + torch.arange(sq, dtype=torch.int32,
                                              device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(sk, dtype=torch.int32, device=dev)
    if use_flash and (q_positions.ndim > 1 or kv_positions.ndim > 1):
        raise ValueError("flash attention does not support per-sequence "
                         "positions; use the blocked path")
    if use_flash and dims.softcap == 0:
        from repro_torch.nn.flash import flash_attention

        out = flash_attention(qg, k, v, q_positions, kv_positions,
                              dims.causal, dims.window, q_block, kv_block)
        return out.reshape(b, sq, hq, hd)
    kt = k.permute(0, 2, 3, 1).unsqueeze(2)          # (b, hkv, 1, hd, sk)
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)          # (b, hkv, 1, sk, hd)

    blocks = []
    for q0 in range(0, sq, q_block):
        q_blk = qg[:, q0:q0 + q_block].permute(0, 2, 3, 1, 4)  # b,h,g,q,d
        qp = q_positions[..., q0:q0 + q_block]
        m_run = torch.full((b, hkv, g, q_block), NEG_INF, device=dev)
        l_run = torch.zeros((b, hkv, g, q_block), device=dev)
        acc = torch.zeros((b, hkv, g, q_block, hd), device=dev)
        for k0 in range(0, sk, kv_block):
            s = _scores(q_blk, kt[..., k0:k0 + kv_block], exact) * scale
            if dims.softcap > 0:
                s = dims.softcap * torch.tanh(s / dims.softcap)
            mask = _block_mask(qp, kv_positions[..., k0:k0 + kv_block], dims)
            mask = mask[None, None, None] if mask.ndim == 2 \
                else mask[:, None, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + _row_sum(p, exact)
            pv = _scores(p.to(v.dtype), vt[..., k0:k0 + kv_block, :], exact)
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-20)
        blocks.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # b,q,h,g,d
    return torch.cat(blocks, dim=1).reshape(b, sq, hq, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, dims: AttnDims, *,
                     cur_pos, cache_positions: Optional[torch.Tensor] = None,
                     exact: bool = False) -> torch.Tensor:
    """Single-step attention over a cache.

    q: (B, 1, Hq, D); k_cache/v_cache: (B, Smax, Hkv, D); cur_pos: () or
    (B,), the position of the new token. Slot i of the cache holds position
    ``cache_positions[..., i]`` (default: i); negative positions mark slots
    never written. ``exact`` as in `blocked_attention`.
    """
    b, _, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, hkv, g, hd)
    dt = torch.promote_types(q.dtype, k_cache.dtype)   # einsum's promotion
    s = _scores(qg.to(dt), k_cache.permute(0, 2, 3, 1).to(dt), exact) * scale
    if dims.softcap > 0:
        s = dims.softcap * torch.tanh(s / dims.softcap)
    pos = cache_positions if cache_positions is not None else torch.arange(
        smax, device=q.device)
    if pos.ndim == 1:
        pos = pos[None, :]                    # (1, Smax) -> broadcast over B
    cur = torch.as_tensor(cur_pos, device=q.device)
    cur = cur[..., None] if cur.ndim else cur
    valid = (pos <= cur) & (pos >= 0)         # (B or 1, Smax)
    if dims.window > 0:
        valid &= pos > cur - dims.window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if exact:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / _row_sum(e, True)[..., None]
        out = _scores(p.to(v_cache.dtype), v_cache.permute(0, 2, 1, 3), True)
    else:
        p = torch.softmax(s, dim=-1)
        out = torch.matmul(p.to(v_cache.dtype), v_cache.permute(0, 2, 1, 3))
    return out.to(v_cache.dtype).reshape(b, 1, hq, hd)


# ----------------------------------------------------------------- full layer


def apply_attention(params, x: torch.Tensor, dims: AttnDims, *,
                    positions: Optional[torch.Tensor] = None,
                    qcfg: QuantConfig = QuantConfig.off(), comp=None,
                    name: str = "attn",
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    q_block: int = 512, kv_block: int = 512,
                    return_kv: bool = False, w_eff=None,
                    use_flash: bool = False, tp=None):
    """Prefill attention over (B, S, d_model). Returns the output, or
    (output, (k, v)) with post-RoPE K/V when ``return_kv`` (prefill cache
    capture). ``kv``: cross-attention, keys and values (B, S_kv, Hkv, D)
    given (no RoPE), at positions 0..S_kv-1 (with ``tp``, the K/V heads
    this rank's heads read). ``use_flash``: `blocked_attention`'s flash
    backward. ``tp``: this rank's heads only (`_project`); the K/V it
    returns are the ones those heads read."""
    b, s, _ = x.shape
    dev = x.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev).expand(b, s)
    shared = _shared_input(x, tp, qcfg)
    q = _project(params, x, qcfg, comp, name, "wq", "bq", w_eff, tp,
                 shared=shared)
    kv_positions = None
    if kv is None:
        sel = _kv_select(tp, dims, params["wk"])
        k = _project(params, x, qcfg, comp, name, "wk", "bk", w_eff, tp, sel,
                     shared)
        v = _project(params, x, qcfg, comp, name, "wv", "bv", w_eff, tp, sel,
                     shared)
        if dims.rope_theta > 0:
            q = apply_rope(q, positions, dims.rope_theta)
            k = apply_rope(k, positions, dims.rope_theta)
    else:
        k, v = kv
        kv_positions = torch.arange(k.shape[1], dtype=torch.int32,
                                    device=dev)
    k_ret, v_ret = k, v

    # pad S to block multiples: padded keys sit past every query (causal);
    # the non-causal mask keeps them, as the JAX package's does
    pad_q = (-s) % q_block
    pad_k = (-k.shape[1]) % kv_block
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        if kv_positions is not None:
            kv_positions = torch.cat([kv_positions, torch.full(
                (pad_k,), 1 << 30, dtype=torch.int32, device=dev)])
    out = blocked_attention(q, k, v, dims, q_block=q_block,
                            kv_block=kv_block, kv_positions=kv_positions,
                            exact=qcfg.batch_invariant, use_flash=use_flash)
    if pad_q:
        out = out[:, :s]
    out = _project(params, out, qcfg, comp, name, "wo", w_eff=w_eff, tp=tp)
    if return_kv:
        return out, (k_ret, v_ret)
    return out


def init_kv_cache(batch: int, max_len: int, dims: AttnDims,
                  dtype=torch.bfloat16, *, device):
    return {key: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for key, s in kv_cache_spec(batch, max_len, dims, dtype).items()}


def kv_cache_spec(batch: int, max_len: int, dims: AttnDims,
                  dtype=torch.bfloat16):
    """{"k", "v"}: shape-and-dtype placeholders (meta tensors) of a cache."""
    shape = (batch, max_len, dims.n_kv_heads, dims.head_dim)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


def apply_attention_decode(params, x: torch.Tensor, cache: dict, pos,
                           dims: AttnDims, *,
                           qcfg: QuantConfig = QuantConfig.off(), comp=None,
                           name: str = "attn", w_eff=None,
                           cross_kv: Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]] = None,
                           tp=None) -> Tuple[torch.Tensor, dict]:
    """One decode step: x (B, 1, d_model), cache {"k", "v"} (B, Smax, Hkv,
    D), pos () or (B,) the current position(s). Returns (output (B, 1, d),
    updated cache). Each row writes its own slot (``pos mod Smax``: a ring
    for windowed layers) and masks against its own position.
    ``cross_kv``: cross-attention, the query attends over every key of
    (xk, xv) and the cache passes through unchanged. ``tp``: this rank's
    query heads; the cache (and ``cross_kv``) holds its K/V heads, or
    every K/V head where the guard replicated them (then each rank
    computes the new token's K/V for all of them, keeping the replicated
    cache whole, and attends over the ones its heads read)."""
    b = x.shape[0]
    dev = x.device
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(b)
    positions = pos_b[:, None]  # (B, 1)
    shared = _shared_input(x, tp, qcfg)
    q = _project(params, x, qcfg, comp, name, "wq", "bq", w_eff, tp,
                 shared=shared)
    if cross_kv is not None:
        sel = _kv_select(tp, dims, params["wk"])
        ck, cv = cross_kv if sel is None \
            else (cross_kv[0][:, :, sel], cross_kv[1][:, :, sel])
        out = decode_attention(
            q, ck, cv, dataclasses.replace(dims, causal=False, window=0),
            cur_pos=1 << 30, exact=qcfg.batch_invariant)
        return _project(params, out, qcfg, comp, name, "wo",
                        w_eff=w_eff, tp=tp), cache
    sel = _kv_select(tp, dims, params["wk"])
    kv_tp = tp if sel is None else None
    k_new = _project(params, x, qcfg, comp, name, "wk", "bk", w_eff, kv_tp,
                     shared=shared)
    v_new = _project(params, x, qcfg, comp, name, "wv", "bv", w_eff, kv_tp,
                     shared=shared)
    if dims.rope_theta > 0:
        q = apply_rope(q, positions, dims.rope_theta)
        k_new = apply_rope(k_new, positions, dims.rope_theta)

    smax = cache["k"].shape[1]
    idx = torch.arange(smax, dtype=torch.int32, device=dev)
    write = (idx[None, :] == torch.remainder(pos_b, smax)[:, None])[
        ..., None, None]                                 # (B, Smax, 1, 1)
    k_cache = torch.where(write, k_new.to(cache["k"].dtype), cache["k"])
    v_cache = torch.where(write, v_new.to(cache["v"].dtype), cache["v"])
    # slot i holds the largest position congruent to i (mod Smax) that is
    # <= pos; slots never written resolve to negative positions
    cache_positions = idx[None, :] + torch.div(
        pos_b[:, None] - idx[None, :], smax, rounding_mode="floor") * smax
    read = (k_cache, v_cache) if sel is None \
        else (k_cache[:, :, sel], v_cache[:, :, sel])
    out = decode_attention(q, *read, dims, cur_pos=pos_b,
                           cache_positions=cache_positions,
                           exact=qcfg.batch_invariant)
    out = _project(params, out, qcfg, comp, name, "wo", w_eff=w_eff, tp=tp)
    return out, {"k": k_cache, "v": v_cache}


def apply_attention_chunk(params, x: torch.Tensor, cache: dict,
                          positions: torch.Tensor, dims: AttnDims, *,
                          qcfg: QuantConfig = QuantConfig.off(), comp=None,
                          name: str = "attn", q_block: int = 8,
                          kv_block: int = 8, w_eff=None
                          ) -> Tuple[torch.Tensor, dict]:
    """Chunked-prefill attention step: x (B, C, d_model), one prefill chunk
    per row at absolute ``positions`` (B, C); cache {"k", "v"} (B, Smax,
    Hkv, D). Returns (output (B, C, d), new cache).

    Writes the chunk's post-RoPE K/V into each row's cache (last write wins
    per slot), then runs `blocked_attention` over the *whole* cache with
    per-row positions. Slots the row has not reached yet resolve, by the
    largest-position-congruent-to-slot formula of decode, to negative
    positions and are masked as ``1 << 30`` (after every query), so stale
    entries from a previous occupant of the slot are invisible. Masked key
    blocks add exactly zero, so with a float32 cache the chunked pass equals
    one full prefill over the same tokens.

    Ring caches (windowed layers with Smax < total length) are not
    supported: a chunk write could evict keys still inside an earlier
    query's window. The engine checks ``Smax >= max positions`` first.
    """
    b, c, _ = x.shape
    dev = x.device
    smax = cache["k"].shape[1]
    positions = positions.to(torch.int32)
    q = _project(params, x, qcfg, comp, name, "wq", "bq", w_eff)
    k_new = _project(params, x, qcfg, comp, name, "wk", "bk", w_eff)
    v_new = _project(params, x, qcfg, comp, name, "wv", "bv", w_eff)
    if dims.rope_theta > 0:
        q = apply_rope(q, positions, dims.rope_theta)
        k_new = apply_rope(k_new, positions, dims.rope_theta)

    # scatter the chunk into the cache, last write wins per slot (a chunk
    # never wraps, see above, so "last" is just in order)
    idx = torch.arange(smax, dtype=torch.int32, device=dev)
    hits = torch.remainder(positions, smax)[:, :, None] == idx[None, None, :]
    order = torch.where(hits, torch.arange(c, dtype=torch.int32,
                                           device=dev)[None, :, None],
                        torch.full((), -1, dtype=torch.int32, device=dev))
    src = order.amax(dim=1)                          # (B, Smax); -1 untouched
    written = (src >= 0)[..., None, None]
    gather_idx = src.clamp(min=0).long()[..., None, None]

    def scatter(old, new):
        gathered = torch.gather(new, 1, gather_idx.expand(
            b, smax, *new.shape[2:]))
        return torch.where(written, gathered.to(old.dtype), old)

    k_cache = scatter(cache["k"], k_new)
    v_cache = scatter(cache["v"], v_new)

    cur = positions[:, -1]                           # (B,) last chunk position
    cache_positions = idx[None, :] + torch.div(
        cur[:, None] - idx[None, :], smax, rounding_mode="floor") * smax
    far = torch.full((), 1 << 30, dtype=torch.int32, device=dev)
    kv_positions = torch.where(cache_positions >= 0, cache_positions, far)

    pad_q = (-c) % q_block
    pad_k = (-smax) % kv_block
    q_pos = positions
    kf, vf = k_cache.to(q.dtype), v_cache.to(q.dtype)
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.cat([q_pos, q_pos[:, -1:].expand(b, pad_q)], dim=1)
    if pad_k:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad_k))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad_k))
        kv_positions = torch.cat([kv_positions, far.expand(b, pad_k)], dim=1)
    out = blocked_attention(q, kf, vf, dims, q_block=q_block,
                            kv_block=kv_block, q_positions=q_pos,
                            kv_positions=kv_positions,
                            exact=qcfg.batch_invariant)
    if pad_q:
        out = out[:, :c]
    out = _project(params, out, qcfg, comp, name, "wo", w_eff=w_eff)
    return out, {"k": k_cache, "v": v_cache}
