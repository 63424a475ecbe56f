"""Minimal optimizer stack over tensor trees (port of
`repro.optim.optimizers`).

`Optimizer` is an (init, update) pair over nested dicts / lists / tuples of
tensors, with ``update(grads, state, params) -> (updates, new_state)``;
``updates`` are *deltas* to add to params. The state layout is the JAX
package's (`adamw`: ``{"step", "mu", "nu"}``), so a plan written by either
package resumes in the other. Learning-rate schedules are callables of the
int32 step tensor, which stays on the device: no update reads a value back
to the host.

Every update is the JAX package's, operation for operation, except that the
global norm is summed in float64 and rounded once: a float32 sum's order
depends on the shapes it is reduced over, and the batched schedule sweep
needs candidate j's update to equal the update of candidate j alone.
PyTorch's `torch.optim.AdamW` is not used: it applies the bias correction
and ``eps`` in another order and has no global-norm clip. The functions run
under `torch.no_grad` and return new tensors; nothing is updated in place.

Candidates. `adamw`'s state may carry a leading candidate axis n on every
leaf (``step`` of shape (n,), as `repro_torch.core.qat.stack_pytrees`
builds it), with grads and params of the same layout: each candidate then
takes its own update, its own global-norm clip and bias correction
included, the one the unbatched update gives it.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch._device import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def _lr_fn(lr) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    # a fill on the step's device: no host-to-device copy per step
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _per_candidate(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-candidate (n,) value shaped to broadcast against ``like``'s
    (n, ...); a 0-d value as it is."""
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim)) if v.ndim else v


def sq_sum(x: torch.Tensor) -> torch.Tensor:
    """One leaf's float64 sum of squares, as `global_norm` sums it."""
    return x.double().square().sum(-1).sum()


@torch.no_grad()
def global_norm(tree, cands: bool = False) -> torch.Tensor:
    """The float32 norm of every leaf together, its squares summed in
    float64 and rounded once; ``cands``: one norm a candidate (the leading
    axis of every leaf), shape (n,)."""
    if not cands:
        total = torch.stack([sq_sum(x) for x in tree_leaves(tree)]).sum(0)
        return torch.sqrt(total).float()
    total = torch.stack([x.double().reshape(x.shape[0], -1).square().sum(-1)
                         for x in tree_leaves(tree)]).sum(0)
    return torch.sqrt(total).float()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, cands: bool = False,
                        norm_fn=None):
    """``grads`` scaled to a global norm of at most ``max_norm``.
    ``norm_fn(grads)``: the norm where the leaves are slices of sharded
    tensors (`repro_torch.distributed.sharding.sharded_global_norm`)."""
    norm = global_norm(grads, cands) if norm_fn is None else norm_fn(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * _per_candidate(scale, g), grads), norm


def adamw(lr: Union[Callable[[torch.Tensor], torch.Tensor], float], *,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          max_grad_norm: Optional[float] = 1.0, norm_fn=None) -> Optimizer:
    """AdamW with global-norm clipping (``norm_fn``: see
    `clip_by_global_norm`)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        leaf = tree_leaves(params)[0]
        return {"step": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params):
        cands = state["step"].ndim == 1
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm, cands,
                                           norm_fn)
        step = state["step"] + 1
        stepf = step.float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                       state["nu"], grads)
        mu_hat_scale = 1.0 / (1.0 - b1 ** stepf)
        nu_hat_scale = 1.0 / (1.0 - b2 ** stepf)
        lr_t = lr_fn(step)

        def upd(m, v, p):
            mh = m * _per_candidate(mu_hat_scale, m)
            vh = v * _per_candidate(nu_hat_scale, v)
            delta = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                delta = delta + weight_decay * p
            return (-_per_candidate(lr_t, p) * delta).to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def sgdm(lr: Union[Callable[[torch.Tensor], torch.Tensor], float], *,
         momentum: float = 0.9, weight_decay: float = 0.0,
         nesterov: bool = False,
         max_grad_norm: Optional[float] = None) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        leaf = tree_leaves(params)[0]
        return {"step": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "vel": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        vel = tree_map(lambda v, g: momentum * v + g, state["vel"], grads)
        if nesterov:
            eff = tree_map(lambda v, g: momentum * v + g, vel, grads)
        else:
            eff = vel
        updates = tree_map(lambda e, p: (-lr_t * e).to(p.dtype), eff, params)
        return updates, {"step": step, "vel": vel}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
