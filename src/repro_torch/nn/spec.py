"""Spec-first parameter system (port of `repro.nn.spec`).

Models are described by *spec trees*: nested dicts whose leaves are
`ParamSpec` (shape, dtype, logical axes, initializer). `init_params` turns a
spec tree into a tree of tensors of the same structure, so the port's
parameters keep the JAX package's names and layouts (HWIO conv kernels,
(in, out) dense weights) and `params_from_numpy` can carry JAX-initialized
weights across unchanged.

Initializers draw from a `torch.Generator` on the CPU and the result moves to
the requested device, so a seed gives the same weights on every device. The
values differ from `jax.random`'s; parity tests carry weights across instead.
"""

from __future__ import annotations

import dataclasses
import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import tree_map

# the most leaves `init_params` draws at once
INIT_THREADS = 16

Initializer = Callable[[torch.Generator, Tuple[int, ...], torch.dtype],
                       torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of a single parameter."""

    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    axes: Tuple[Optional[str], ...] = ()
    init: Optional[Initializer] = None

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")



# ----------------------------------------------------------------- initializers

def zeros_init(gen, shape, dtype):
    del gen
    return torch.zeros(shape, dtype=dtype)


def ones_init(gen, shape, dtype):
    del gen
    return torch.ones(shape, dtype=dtype)


def normal_init(stddev: float = 0.02):
    def init(gen, shape, dtype):
        return (torch.randn(shape, generator=gen) * stddev).to(dtype)

    return init


def _fan_in(shape, in_axis: int) -> int:
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    # conv kernels (kh, kw, cin, cout): fan_in = kh*kw*cin
    if len(shape) == 4:
        fan_in = shape[0] * shape[1] * shape[2]
    return fan_in


def fan_in_init(in_axis: int = -2, scale: float = 1.0):
    """LeCun-normal style init: stddev = scale / sqrt(fan_in)."""

    def init(gen, shape, dtype):
        if len(shape) == 0:
            return torch.zeros(shape, dtype=dtype)
        std = scale / math.sqrt(max(_fan_in(shape, in_axis), 1))
        return (torch.randn(shape, generator=gen) * std).to(dtype)

    return init


# ----------------------------------------------------------------- derivations

def init_params(seed: int, spec_tree, device) -> Any:
    """Concretely initialize every parameter; leaf ``name`` draws from a
    generator seeded by (seed, crc32(name)), so adding a layer leaves the
    others' values unchanged. The leaves are independent, so they are drawn
    at the same time, one thread a leaf (torch's draws release the GIL);
    each leaf's values are those of a draw alone, bit for bit."""
    leaves = []

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, f"{name}{k}/") for k, v in node.items()}
        leaves.append((name, node))
        return len(leaves) - 1

    def draw(item):
        name, node = item
        gen = torch.Generator().manual_seed(
            (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (1 << 63))
        fn = node.init or normal_init(0.02)
        return fn(gen, node.shape, node.dtype).to(device)

    tree = walk(spec_tree, "")
    workers = min(len(leaves), os.cpu_count() or 1, INIT_THREADS)
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            values = list(pool.map(draw, leaves))
    else:
        values = [draw(item) for item in leaves]
    return tree_map(lambda i: values[i], tree)


def abstract_params(spec_tree, dtype=None) -> Any:
    """The spec tree as meta tensors (shape and dtype, no storage):
    ``dtype`` in place of every leaf's own when given."""
    return tree_map(lambda s: torch.empty(
        s.shape, dtype=s.dtype if dtype is None else dtype, device="meta"),
        spec_tree)


def _spec_leaves(spec_tree) -> list:
    if isinstance(spec_tree, dict):
        return [s for v in spec_tree.values() for s in _spec_leaves(v)]
    return [spec_tree]


def spec_count(spec_tree) -> int:
    """Total parameter count implied by the spec tree."""
    return sum(math.prod(s.shape) for s in _spec_leaves(spec_tree))


def stack_specs(spec_tree, n_layers: int,
                layer_axis_name: Optional[str] = None) -> Any:
    """Lift a per-layer spec tree to a stacked (one leading layer axis) spec
    tree: each leaf (shape, axes) becomes ((n_layers, *shape),
    (layer_axis_name, *axes)). Its initializer draws the layers one after
    another from the leaf's generator, each at the per-layer shape (so a
    fan-in initializer sees the layer's fan-in, not the layer count)."""

    def lift(s):
        if isinstance(s, dict):
            return {k: lift(v) for k, v in s.items()}
        base = s.init or normal_init(0.02)

        def stacked_init(gen, shape, dtype, _base=base, _inner=s.shape):
            return torch.stack([_base(gen, _inner, dtype)
                                for _ in range(shape[0])])

        axes = s.axes if s.axes else (None,) * len(s.shape)
        return ParamSpec(shape=(n_layers, *s.shape), dtype=s.dtype,
                         axes=(layer_axis_name, *axes), init=stacked_init)

    return lift(spec_tree)


def flatten_with_names(tree, prefix: str = "") -> Dict[str, Any]:
    """{'a/b/c': leaf} view of a nested-dict tree (keys sorted, as the JAX
    package's)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(flatten_with_names(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_with_names(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def params_from_numpy(tree, device) -> Any:
    """Numpy (or anything `np.asarray` accepts) parameter tree -> tensors on
    ``device``, structure unchanged, nested LM trees included (stacked
    ``(L, ...)`` leaves stay stacked under the same key paths). Carries the
    JAX package's parameters into the port:
    ``params_from_numpy(jax.device_get(params), "cpu")``."""

    def conv(a):
        if isinstance(a, (bool, int, float, str)) or a is None:
            return a
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":     # ml_dtypes: no torch mapping
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    return tree_map(conv, tree)

