"""1-D device meshes of one process (port of the 1-D part of
`repro.distributed.sharding`).

The JAX package's 1-D meshes belong to one controller and need no
collective beyond a sum (the profiler's four trace statistics) or a gather
(per-candidate and per-row results). Their counterpart here is one Python
process: `LocalMesh` is an ordered tuple of `torch.device` and one axis
name; a caller splits a leading axis into one slice a shard
(`split_leading`), runs each shard's slice on that shard's device
(`to_device`, `device_scope`) and sums or concatenates the results on one
device (`concat_leading`). No launcher, no rendezvous, no process group.

A device may appear more than once: its shards then run one after another
on it. That is how one card, or the CPU, checks the split, the padding and
the reduction of a mesh of any size (``LocalMesh(("cpu",) * 4, "tiles")``).

    tile_mesh()     ("tiles",)       the profiler's tile batch
    sweep_mesh()    ("candidates",)  the schedule's candidate sweep
    request_mesh()  ("requests",)    the serving engine's wave rows

Called with no argument each takes every visible CUDA card once, as the
JAX package's take ``jax.devices()``; on a host without CUDA that raises
(pass CPU devices to build a CPU mesh). The logical-axis rules
(`ShardingRules`, `logical_to_spec`, parameter shardings) are the 2-D half
of ROADMAP.md item 10 and are not ported here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device, tree_leaves, tree_map

TILE_AXIS = "tiles"
SWEEP_AXIS = "candidates"
REQUEST_AXIS = "requests"


def _mesh_device(device) -> torch.device:
    """A usable device with its index filled in (``"cuda"`` -> the current
    card), so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A 1-D mesh of devices driven by one process: shard i of ``axis``
    runs on ``devices[i]``."""

    devices: Tuple[torch.device, ...]
    axis: str

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(_mesh_device(d) for d in self.devices))

    @property
    def shape(self) -> dict:
        """``{axis: shard count}``, as a JAX mesh's ``shape``."""
        return {self.axis: len(self.devices)}

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device results are summed or gathered on."""
        return self.devices[0]

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over the visible CUDA cards was requested but "
            "torch.cuda.is_available() is False on this host; pass the "
            "devices (e.g. ['cpu'] * 4) to build a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_mesh(devices: Optional[Sequence], axis: str) -> LocalMesh:
    """A 1-D mesh over ``devices`` (every visible CUDA card once when
    None)."""
    return LocalMesh(tuple(_visible_cards() if devices is None
                           else devices), axis)


def tile_mesh(devices: Optional[Sequence] = None) -> LocalMesh:
    """1-D ("tiles",) mesh for batched profiling: each shard traces its
    slice of a layer's stacked tile batch and the four statistics are
    summed (`repro_torch.core.profiler.sharded_layer_stats`)."""
    return local_mesh(devices, TILE_AXIS)


def sweep_mesh(devices: Optional[Sequence] = None) -> LocalMesh:
    """1-D ("candidates",) mesh for the schedule's batched candidate sweep:
    each shard trains and evaluates its slice of the stacked candidates;
    `CnnRunner` pads the candidate batch to a multiple of the mesh size and
    drops the padded slots."""
    return local_mesh(devices, SWEEP_AXIS)


def request_mesh(devices: Optional[Sequence] = None) -> LocalMesh:
    """1-D ("requests",) mesh for the serving engine: a wave whose row count
    divides the mesh runs each shard's rows on its device
    (`ServingEngine(mesh=...)`)."""
    return local_mesh(devices, REQUEST_AXIS)


def check_mesh(mesh, axis: str) -> LocalMesh:
    """``mesh`` if it is a `LocalMesh` over ``axis``; `TypeError` for any
    other object, `ValueError` for another axis."""
    if not isinstance(mesh, LocalMesh):
        maker = {TILE_AXIS: "tile_mesh", SWEEP_AXIS: "sweep_mesh",
                 REQUEST_AXIS: "request_mesh"}.get(axis, "local_mesh")
        raise TypeError(f"mesh must be a repro_torch.distributed.LocalMesh "
                        f"(e.g. {maker}()), got {type(mesh).__name__}")
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r}; this path shards over "
                         f"{axis!r}")
    return mesh


def device_scope(device: torch.device):
    """Make ``device`` the current card while a shard's work is launched
    (nothing to do on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _leaf_to(x, device: torch.device):
    if not isinstance(x, torch.Tensor):
        return x
    if x.device == device:
        return x
    if x.ndim and x.shape[0] > 1 and x.stride(0) == 0:
        # a stride-0 candidate axis (`qat.broadcast_pytree`) stays one
        return x[:1].to(device).expand(x.shape)
    return x.to(device)


def to_device(tree, device: torch.device):
    """Every tensor of a nested dict / list / tuple (and of dataclass leaves
    such as `ServeArtifact`) on ``device``; tensors already there are not
    copied, and a leaf whose leading axis has stride 0 stays a stride-0
    view."""
    def one(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: to_device(getattr(x, f.name), device)
                for f in dataclasses.fields(x) if f.init})
        return _leaf_to(x, device)

    return tree_map(one, tree)


def split_leading(tree, n: int) -> List:
    """``n`` trees, tree i holding the i-th of ``n`` equal slices of every
    leaf's leading axis (views; a stride-0 leaf gives stride-0 slices). A
    tree without leaves (a model with no state) is its own every slice."""
    leaves = tree_leaves(tree)
    if not leaves:
        return [tree] * n
    size = int(leaves[0].shape[0])
    if size % n:
        raise ValueError(f"leading axis {size} does not split into {n} "
                         "equal shards")
    step = size // n
    return [tree_map(lambda x, i=i: x[i * step:(i + 1) * step], tree)
            for i in range(n)]


def concat_leading(trees: Iterable, device: torch.device):
    """Per-shard trees of one structure concatenated along the leading axis
    on ``device``, in shard order (one tree is moved, not copied)."""
    trees = list(trees)
    if len(trees) == 1:
        return to_device(trees[0], device)
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                    *trees)


def sum_on(tensors: Iterable[torch.Tensor], device: torch.device
           ) -> torch.Tensor:
    """The sum of per-shard tensors on ``device``, added in shard order."""
    total = None
    for t in tensors:
        t = t.to(device)
        total = t if total is None else total + t
    return total
