"""Device resolution for the port's entry points, and tensor-tree helpers.

Entry points run on the card unless the caller asks for the CPU. Asking for
CUDA on a host without it is an error, never a quiet switch to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``"cuda"`` / ``"cpu"`` / a `torch.device` -> a usable `torch.device`.

    Raises `RuntimeError` when CUDA is requested and unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False on this host; pass device='cpu' (CLI: --device cpu) to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple, or to the
    matching leaves of several trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *vs) for vs in zip(tree, *rest))
    if isinstance(tree, list):
        return [tree_map(fn, *vs) for vs in zip(tree, *rest)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict/list/tuple, dicts in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in `tree_leaves` order
    from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_unflatten(v, leaves) for v in tree)
    if isinstance(tree, list):
        return [tree_unflatten(v, leaves) for v in tree]
    return next(leaves)


def tree_to(tree, device):
    """Move every tensor of a nested dict/list/tuple to ``device``."""
    return tree_map(
        lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)
