"""Attention: GQA/MQA/MHA + RoPE + sliding window + KV cache (port of
`repro.nn.attention`).

Prefill runs the JAX package's double-blocked online-softmax schedule
(`blocked_attention`: query blocks, and inside each a walk over key/value
blocks with a running maximum and sum, in float32), so its results follow
the reference's rounding; the scores and the probability-weighted values
are plain `torch.matmul` products in the activations' dtype (not quantized
products: no kernel of the TPU path computes them). Decode is one query
against the cache. Query heads are grouped over the K/V heads as
``(B, S, Hkv, G, D)``, as in the reference.

The projections are compressible units: they take the same
(``qcfg``, ``comp``) pair as the dense layers. On the serve path a unit with
a `ServeArtifact` runs on the packed LUT GEMM (K2); under QAT its weight is
fake-quantized (``w_eff``: the model's one grouped K3 launch computed it)
and the product is correctly rounded (`exact_matmul`), so the two paths
agree to float32 ulps. ``apply_attention_chunk`` (chunked prefill) belongs
to the serving engine and is not ported yet (ROADMAP.md item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import qat
from repro_torch.core.export import serve_dense
from repro_torch.kernels.lut_matmul.ref import exact_matmul
from repro_torch.nn.layers import QuantConfig
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
             bias_key: Optional[str] = None, w_eff=None):
    """One projection: wq/wk/wv ``(B, S, d) -> (B, S, H, hd)`` (served
    ``in_first`` as (d, H*hd)), wo ``(B, S, H, hd) -> (B, S, d)`` (served
    ``out_last`` as (H*hd, d)). ``w_eff``: {"attn/wq": fake-quantized
    weight, ...} where the caller computed them."""
    w = params[key]                        # (d, H, hd) or (H, hd, d)
    unit = f"{name}/{key}"
    c = None if comp is None else comp.get(unit)
    if qcfg.enabled and qcfg.act_quant:
        x = qat.fake_quant_act(x)
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
    w_mat = (w.reshape(-1, w.shape[-1]) if key == "wo"
             else w.reshape(w.shape[0], -1)).to(x.dtype)
    y = (exact_matmul(x, w_mat) if qcfg.enabled
         else torch.matmul(x, w_mat)).to(x.dtype)
    if key != "wo":
        y = y.reshape(*x.shape[:-1], w.shape[1], w.shape[2])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


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


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dims: AttnDims, *, q_offset: int = 0,
                      q_block: int = 512, kv_block: int = 512,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D),
    Sq and Sk multiples of the block sizes (callers pad).

    GQA reshapes the queries to (B, S, Hkv, G, D). Each query block walks
    the key/value blocks in order with a running maximum, sum and output in
    float32 (the JAX package's ``lax.scan`` schedule, written as loops);
    fully masked key blocks add exactly zero once a real key has been seen.
    The JAX package's ``use_flash`` branch (a training custom VJP) is not
    ported (ROADMAP.md item 6b).
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
            s = torch.matmul(q_blk, kt[..., k0:k0 + kv_block]).float()
            s = s * scale
            if dims.softcap > 0:
                s = dims.softcap * torch.tanh(s / dims.softcap)
            mask = _block_mask(qp, kv_positions[..., k0:k0 + kv_block], dims)
            mask = mask[None, None, None] if mask.ndim == 2 \
                else mask[:, None, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype), vt[..., k0:k0 + kv_block, :])
            acc = acc * alpha[..., None] + pv.float()
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-20)
        blocks.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # b,q,h,g,d
    return torch.cat(blocks, dim=1).reshape(b, sq, hq, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, dims: AttnDims, *,
                     cur_pos, cache_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-step attention over a cache.

    q: (B, 1, Hq, D); k_cache/v_cache: (B, Smax, Hkv, D); cur_pos: () or
    (B,), the position of the new token. Slot i of the cache holds position
    ``cache_positions[..., i]`` (default: i); negative positions mark slots
    never written.
    """
    b, _, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, hkv, g, hd)
    dt = torch.promote_types(q.dtype, k_cache.dtype)   # einsum's promotion
    s = torch.matmul(qg.to(dt), k_cache.permute(0, 2, 3, 1).to(dt))
    s = s.float() * scale
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
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v_cache.dtype), v_cache.permute(0, 2, 1, 3))
    return out.reshape(b, 1, hq, hd)


# ----------------------------------------------------------------- full layer


def apply_attention(params, x: torch.Tensor, dims: AttnDims, *,
                    positions: Optional[torch.Tensor] = None,
                    qcfg: QuantConfig = QuantConfig.off(), comp=None,
                    name: str = "attn", q_block: int = 512,
                    kv_block: int = 512, return_kv: bool = False,
                    w_eff=None):
    """Prefill attention over (B, S, d_model). Returns the output, or
    (output, (k, v)) with post-RoPE K/V when ``return_kv`` (prefill cache
    capture). Cross-attention (the JAX package's ``kv``) belongs to the
    encoder-decoder family and is not ported (ROADMAP.md item 6c)."""
    b, s, _ = x.shape
    dev = x.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev).expand(b, s)
    q = _project(params, x, qcfg, comp, name, "wq", "bq", w_eff)
    k = _project(params, x, qcfg, comp, name, "wk", "bk", w_eff)
    v = _project(params, x, qcfg, comp, name, "wv", "bv", w_eff)
    if dims.rope_theta > 0:
        q = apply_rope(q, positions, dims.rope_theta)
        k = apply_rope(k, positions, dims.rope_theta)
    k_ret, v_ret = k, v

    # pad S to block multiples (padded keys sit past every query: causal)
    pad_q = (-s) % q_block
    pad_k = (-k.shape[1]) % kv_block
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    out = blocked_attention(q, k, v, dims, q_block=q_block,
                            kv_block=kv_block)
    if pad_q:
        out = out[:, :s]
    out = _project(params, out, qcfg, comp, name, "wo", w_eff=w_eff)
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
                           name: str = "attn", w_eff=None
                           ) -> Tuple[torch.Tensor, dict]:
    """One decode step: x (B, 1, d_model), cache {"k", "v"} (B, Smax, Hkv,
    D), pos () or (B,) the current position(s). Returns (output (B, 1, d),
    updated cache). Each row writes its own slot (``pos mod Smax``: a ring
    for windowed layers) and masks against its own position."""
    b = x.shape[0]
    dev = x.device
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(b)
    positions = pos_b[:, None]  # (B, 1)
    q = _project(params, x, qcfg, comp, name, "wq", "bq", w_eff)
    k_new = _project(params, x, qcfg, comp, name, "wk", "bk", w_eff)
    v_new = _project(params, x, qcfg, comp, name, "wv", "bv", w_eff)
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
    out = decode_attention(q, k_cache, v_cache, dims, cur_pos=pos_b,
                           cache_positions=cache_positions)
    out = _project(params, out, qcfg, comp, name, "wo", w_eff=w_eff)
    return out, {"k": k_cache, "v": v_cache}
