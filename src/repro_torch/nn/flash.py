"""Flash-attention backward for the blocked attention path (port of
`repro.nn.flash`).

Autograd through the double-blocked online-softmax forward saves every
(q-block, kv-block) probability tile for the backward pass, an
O(nq * nk * B * H * q_block * kv_block) float32 stack a layer. This module
computes the standard FlashAttention backward instead, as a
`torch.autograd.Function`: the forward saves only (q, k, v, out, lse); the
backward recomputes each score tile from q, k and the saved log-sum-exp,
accumulating dq over the key blocks of each query block and dk/dv into
full-size float32 buffers. It is the JAX package's custom VJP, operation
for operation (the same blocks in the same order, float32 scores, the
probabilities cast to the values' dtype before the weighted sum), written
as loops over the blocks; it is not `scaled_dot_product_attention`.

The semantics are `attention.blocked_attention`'s: GQA grouping, causal
and window masks. Softcap is not supported here: callers with a softcap
take the autograd path, as in the JAX package.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _forward(q, k, v, q_positions, kv_positions, causal, window, q_block,
             kv_block):
    """(out (B, Sq, Hkv, G, D) in q's dtype, lse (B, Sq, Hkv, G) float32)."""
    b, sq, hkv, g, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    kt = k.permute(0, 2, 3, 1).unsqueeze(2)          # (b, hkv, 1, hd, sk)
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)          # (b, hkv, 1, sk, hd)
    outs, lses = [], []
    for q0 in range(0, sq, q_block):
        q_blk = q[:, q0:q0 + q_block].permute(0, 2, 3, 1, 4)  # b,h,g,q,d
        qp = q_positions[q0:q0 + q_block]
        m_run = torch.full((b, hkv, g, q_block), NEG_INF, device=dev)
        l_run = torch.zeros((b, hkv, g, q_block), device=dev)
        acc = torch.zeros((b, hkv, g, q_block, hd), device=dev)
        for k0 in range(0, sk, kv_block):
            s = torch.matmul(q_blk, kt[..., k0:k0 + kv_block]).float() * scale
            mask = _mask(qp, kv_positions[k0:k0 + kv_block], causal, window)
            s = torch.where(mask[None, None, None], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(v.dtype), vt[..., k0:k0 + kv_block, :]).float()
            m_run = m_new
        l_safe = torch.clamp(l_run, min=1e-20)
        out = (acc / l_safe[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))      # b,q,h,g,d
        lses.append((m_run + torch.log(l_safe)).permute(0, 3, 1, 2))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _backward(q, k, v, out, lse, q_positions, kv_positions, dout, causal,
              window, q_block, kv_block):
    """(dq, dk, dv): each score tile recomputed from q, k and ``lse``."""
    b, sq, hkv, g, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    # delta = rowsum(dout * out) per query row
    delta = (dout.float() * out.float()).sum(dim=-1)         # (b, sq, h, g)
    dk = torch.zeros((b, sk, hkv, hd), device=dev)
    dv = torch.zeros((b, sk, hkv, hd), device=dev)
    dqs = []
    for q0 in range(0, sq, q_block):
        sl = slice(q0, q0 + q_block)
        q_t = q[:, sl].permute(0, 2, 3, 1, 4)                 # b,h,g,q,d
        do_t = dout[:, sl].permute(0, 2, 3, 1, 4).float()
        lse_t = lse[:, sl].permute(0, 2, 3, 1)                # b,h,g,q
        dl_t = delta[:, sl].permute(0, 2, 3, 1)
        qp = q_positions[sl]
        dq_blk = torch.zeros((b, hkv, g, q_block, hd), device=dev)
        for k0 in range(0, sk, kv_block):
            ks = slice(k0, k0 + kv_block)
            k_blk, v_blk = k[:, ks], v[:, ks]                 # b,k,h,d
            s = torch.einsum("bhgqd,bkhd->bhgqk", q_t, k_blk).float() * scale
            mask = _mask(qp, kv_positions[ks], causal, window)
            s = torch.where(mask[None, None, None], s,
                            torch.full_like(s, NEG_INF))
            p = torch.exp(s - lse_t[..., None])               # b,h,g,q,k
            dv[:, ks] += torch.einsum("bhgqk,bhgqd->bkhd", p, do_t)
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do_t, v_blk.float())
            ds = p * (dp - dl_t[..., None]) * scale
            dq_blk = dq_blk + torch.einsum("bhgqk,bkhd->bhgqd", ds,
                                           k_blk.float())
            dk[:, ks] += torch.einsum("bhgqk,bhgqd->bkhd", ds, q_t.float())
        dqs.append(dq_blk.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window,
                q_block, kv_block):
        out, lse = _forward(q, k, v, q_positions, kv_positions, causal,
                            window, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.static = (causal, window, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_positions, kv_positions = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, q_positions, kv_positions,
                               dout, *ctx.static)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool, window: int, q_block: int,
                    kv_block: int) -> torch.Tensor:
    """q: (B, Sq, Hkv, G, D); k, v: (B, Sk, Hkv, D); positions (Sq,) and
    (Sk,) int, shared by the batch. Returns (B, Sq, Hkv, G, D) in q's
    dtype. Sq and Sk must be block multiples (callers pad)."""
    return _FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                 bool(causal), int(window), int(q_block),
                                 int(kv_block))
