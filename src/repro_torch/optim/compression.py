"""Gradient compression for bandwidth-bound data parallelism (port of
`repro.optim.compression`).

Two classic compressors, both with error feedback (EF: the compression
error is added back into the next step's gradient; Seide et al.,
Karimireddy et al.):

  * ``int8_compressor`` — per-leaf symmetric int8 quantization (4x over
    float32 on the wire: int8 codes plus one float32 scale a leaf);
  * ``topk_compressor`` — per leaf, the entries whose magnitude reaches the
    k-th largest (k a fraction of the leaf), the rest zeroed.

`compressed(optimizer, compressor)` wraps any `Optimizer`: the update sees
the *decompressed* gradients (what a compressed all-reduce delivers), the
EF state rides in the optimizer state, and the stats' ``wire_bytes`` and
``raw_bytes`` are the JAX package's simulated network volumes.

The arithmetic is the JAX package's, operation for operation: every
divisor of the int8 path is a float32 device tensor (never a Python float,
which PyTorch's CUDA division turns into a product with its reciprocal),
the codes round half to even (`torch.round`), and the top-k threshold is
the k-th largest magnitude (``jax.lax.top_k(...)[0][-1]``). So the codes
are the same on the card and on the CPU.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch._device import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.optimizers import Optimizer


class Compressor(NamedTuple):
    init: Callable          # params -> ef_state
    compress: Callable      # (grads, ef_state) -> (grads', ef_state', stats)


def _ef_init(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _per_leaf(fn, grads, ef):
    """``fn(g, e) -> (value, new ef)`` over matching leaves: (tree of
    values, tree of new efs), both of ``grads``' structure."""
    new_ef = []

    def value(g, e):
        v, r = fn(g, e)
        new_ef.append(r)
        return v

    values = tree_map(value, grads, ef)
    return values, tree_unflatten(values, iter(new_ef))


def int8_codes(g: torch.Tensor, e: torch.Tensor):
    """(int8 codes, float32 scale, the EF-corrected float32 gradient) of one
    leaf: ``scale = max(max|g + e|, 1e-12) / 127``, codes ``clip(round((g
    + e) / scale), -127, 127)``."""
    gf = g.float() + e
    # 127 as a tensor on the device: a Python float divisor is multiplied
    # by its reciprocal on CUDA, an ulp off the true quotient
    scale = torch.clamp(gf.abs().max(), min=1e-12) / gf.new_tensor(127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q.to(torch.int8), scale, gf


def int8_compressor() -> Compressor:
    @torch.no_grad()
    def compress(grads, ef):
        def one(g, e):
            q, scale, gf = int8_codes(g, e)
            deq = q.float() * scale
            return deq.to(g.dtype), gf - deq

        deq, new_ef = _per_leaf(one, grads, ef)
        leaves = tree_leaves(grads)
        n_elems = sum(g.numel() for g in leaves)
        stats = {"wire_bytes": n_elems * 1 + 4 * len(leaves),
                 "raw_bytes": n_elems * 4}
        return deq, new_ef, stats

    return Compressor(_ef_init, compress)


def topk_compressor(fraction: float = 0.01) -> Compressor:
    @torch.no_grad()
    def compress(grads, ef):
        def one(g, e):
            gf = g.float() + e
            flat = gf.abs().reshape(-1)
            k = max(1, int(fraction * flat.shape[0]))
            thresh = torch.topk(flat, k).values[-1]
            kept = gf * (gf.abs() >= thresh).float()
            return kept.to(g.dtype), gf - kept

        kept, new_ef = _per_leaf(one, grads, ef)
        n_elems = sum(g.numel() for g in tree_leaves(grads))
        kept_elems = int(max(1, fraction * n_elems))
        stats = {"wire_bytes": kept_elems * 8,  # value + index
                 "raw_bytes": n_elems * 4}
        return kept, new_ef, stats

    return Compressor(_ef_init, compress)


def compressed(optimizer: Optimizer, compressor: Compressor) -> Optimizer:
    """Optimizer wrapper: grads pass through the compressor (with EF) before
    the inner update."""

    def init(params):
        return {"inner": optimizer.init(params),
                "ef": compressor.init(params)}

    def update(grads, state, params):
        deq, ef, _stats = compressor.compress(grads, state["ef"])
        updates, inner = optimizer.update(deq, state["inner"], params)
        return updates, {"inner": inner, "ef": ef}

    return Optimizer(init, update)
