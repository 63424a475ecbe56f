"""Device meshes and the logical-axis sharding rules (port of
`repro.distributed.sharding`).

**The 1-D meshes of one process.** The JAX package's 1-D meshes belong to
one controller and need no collective beyond a sum (the profiler's four
trace statistics) or a gather (per-candidate and per-row results). Their
counterpart here is one Python process: `LocalMesh` is an ordered tuple of
`torch.device` and one axis name; a caller splits a leading axis into one
slice a shard (`split_leading`), runs each shard's slice on that shard's
device (`to_device`, `device_scope`) and sums or concatenates the results
on one device (`concat_leading`). No launcher, no rendezvous, no process
group.

A device may appear more than once: its shards then run one after another
on it. That is how one card, or the CPU, checks the split, the padding and
the reduction of a mesh of any size (``LocalMesh(("cpu",) * 4, "tiles")``).

    tile_mesh()     ("tiles",)       the profiler's tile batch
    sweep_mesh()    ("candidates",)  the schedule's candidate sweep
    request_mesh()  ("requests",)    the serving engine's wave rows

Called with no argument each takes every visible CUDA card once, as the
JAX package's take ``jax.devices()``; on a host without CUDA that raises
(pass CPU devices to build a CPU mesh).

**The 2-D meshes and the rules.** Parameters and caches carry *logical*
axis names (`repro_torch.nn.spec.ParamSpec`); `DEFAULT_RULES` maps them
onto mesh axes, as in the JAX package:

    batch    -> ("pod", "data")   data parallel, across pods too
    vocab, heads, kv_heads, mlp, expert, inner -> "model"
    embed    -> "data"            FSDP: parameters and optimizer state
                                  sharded over the data axis
    layers   -> None

**Divisibility guard**: a logical axis whose dimension does not divide the
product of its mesh axes replicates for that tensor, and the guard report
names it (`logical_to_spec`; the text is the JAX package's, letter for
letter).

A mesh here is one of two things, both with ``shape`` (an ordered dict)
and ``axis_names`` as a JAX mesh has:

  * `AbstractMesh`: axis names and sizes only, no process and no device,
    for the rules and the dry run (`repro_torch.launch.dryrun`); one whose
    every axis has size 1 also runs a step in the calling process;
  * `ProcessMesh`: one process a mesh position over a
    `torch.distributed.device_mesh.DeviceMesh` with ``mesh_dim_names``
    (`process_mesh`); each rank holds its own slice of every sharded
    tensor, and the collectives run over the mesh's process groups. Over
    gloo a CUDA tensor goes through the host (gloo has no CUDA all-gather).

`NamedSharding` (mesh, `PartitionSpec`) gives a tensor's shard shape, this
rank's slice (JAX's device -> slice order: a tuple of axes on one tensor
dim puts its first axis outer) and the DTensor placements of the layout
(`Shard(d)` on each mesh dim the spec names at tensor dim d, else
`Replicate()`). `shard_tree` / `gather_tree` / `reshard` move trees
between the full tensors and a rank's slices.

Steps over a mesh reduce over the global batch where the JAX package's
SPMD partitioner would: `batch_reduction` installs a `BatchReduce` that
`repro_torch.core.qat` (the activation amax, MAX), `repro_torch.models.lm`
(the loss's sums and counts) and `repro_torch.nn.moe` (the auxiliary
losses' token means) read while a meshed step runs.

**FSDP a layer.** A meshed step keeps every parameter as this rank's slice
and gathers one layer at a time where the model uses it: `layer_gathering`
installs a `LayerGather` that `repro_torch.models.lm` calls on each block's
slices inside its layer (so remat's recompute gathers again instead of
keeping the full tensors), on the embedding and the read-out at use, and on
the norms. Its gather is `gather_at_use`, an autograd function whose
backward turns the full gradient of this rank's rows into the gradient of
its slice of the global batch (`reduce_to_slice`). `gathered_bytes` counts
the bytes of the gathered tensors (and of the full gradients being reduced)
alive at once, and their peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
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


# ===================================================== 2-D: logical-axis rules

AxisVal = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, AxisVal], ...]

    def lookup(self, logical: Optional[str]) -> AxisVal:
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def replace(self, **kw) -> "ShardingRules":
        new = []
        for k, v in self.rules:
            new.append((k, kw.pop(k, v)))
        for k, v in kw.items():
            new.append((k, v))
        return ShardingRules(tuple(new))


DEFAULT_RULES = ShardingRules((
    ("batch", ("pod", "data")),
    ("seq", "model"),        # sequence parallelism opt-in (a knob)
    ("kv_seq", "model"),     # decode-cache sequence sharding (opt-in; used
                             # when kv_heads cannot divide the model axis)
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("expert", "model"),
    ("moe_ff", None),        # expert FFN dim; switch with expert=None,
                             # moe_ff=model for tensor-parallel experts
    ("moe_embed", "data"),   # expert d_model dim (FSDP by default)
    ("inner", "model"),
    ("embed", "data"),
    ("layers", None),
))


class PartitionSpec(tuple):
    """A tensor's layout: one entry a tensor dim, each None (replicated),
    a mesh axis name, or a tuple of names (sharded over their product, the
    first outer). Missing trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


def _axes_of(entry: AxisVal) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _mesh_size(mesh, axis: AxisVal) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis] if axis in mesh.axis_names else 1
    return int(math.prod(mesh.shape[a] for a in axis
                         if a in mesh.axis_names))


def _present(mesh, axis: AxisVal) -> AxisVal:
    """Drop mesh axes that don't exist in this mesh (e.g. 'pod' single-pod)."""
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in mesh.axis_names else None
    kept = tuple(a for a in axis if a in mesh.axis_names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


# ------------------------------------------------------------------ meshes


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no process and no device (JAX's
    ``AbstractMesh(axis_sizes, axis_names)``): what the rules and the dry
    run need. A mesh whose every axis has size 1 is one process's whole
    world, so a step runs on it in the calling process."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_sizes",
                           tuple(int(n) for n in self.axis_sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"axis sizes {self.axis_sizes} and names "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def device(self) -> Optional[torch.device]:
        return None

    @property
    def coords(self) -> Dict[str, int]:
        if self.size != 1:
            raise TypeError(
                f"an AbstractMesh {self.axis_sizes} has no processes: run "
                "steps on a ProcessMesh (process_mesh) or a 1x1 mesh")
        return {a: 0 for a in self.axis_names}

    def group(self, axes: Sequence[str]):
        """The process group over ``axes``: None, the mesh being one
        process (`coords` raises otherwise)."""
        self.coords
        return None


class ProcessMesh:
    """One process a mesh position: a `DeviceMesh` over the default
    process group's ranks, ``mesh_dim_names`` as axis names. Builds every
    process group a step may reduce over at construction, which every rank
    of the mesh must therefore call together."""

    def __init__(self, device_mesh):
        import torch.distributed as dist

        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.axis_sizes = tuple(int(n) for n in device_mesh.mesh.shape)
        self.ranks: List[int] = [int(r) for r in
                                 device_mesh.mesh.flatten().tolist()]
        rank = dist.get_rank()
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not in the mesh {self.ranks}")
        self.coords = self.coords_of(rank)
        if device_mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(device_mesh.device_type)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        grid = np.asarray(self.ranks).reshape(self.axis_sizes)
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for subset in itertools.combinations(names, k):
                if k == 1:
                    self._groups[subset] = device_mesh.get_group(subset[0])
                    continue
                dims = [names.index(a) for a in subset]
                rest = [i for i in range(len(names)) if i not in dims]
                rows = grid.transpose(rest + dims).reshape(
                    -1, math.prod(self.axis_sizes[i] for i in dims))
                for row in rows.tolist():
                    g = dist.new_group(row)
                    if rank in row:
                        self._groups[subset] = g

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def coords_of(self, rank: int) -> Dict[str, int]:
        pos = np.unravel_index(self.ranks.index(rank), self.axis_sizes)
        return {a: int(i) for a, i in zip(self.axis_names, pos)}

    def group(self, axes: Sequence[str]):
        """The process group of this rank's mesh positions that differ only
        along ``axes``; None where that is this process alone."""
        key = tuple(a for a in self.axis_names if a in set(axes))
        if math.prod(self.shape[a] for a in key) <= 1:
            return None
        return self._groups[key]


def process_mesh(axis_sizes: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model"), *,
                 device_type: Optional[str] = None,
                 ranks: Optional[Sequence[int]] = None) -> ProcessMesh:
    """A `ProcessMesh` of ``axis_sizes`` over the initialized default
    process group (every rank calls it). ``ranks``: the mesh's ranks in
    row-major order (default: the whole world, rank r at position r);
    ``device_type`` (default: ``"cuda"`` when the card is there, else
    ``"cpu"``): where each rank's slices live. Several ranks may share one
    card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a process mesh needs torch.distributed.init_process_group("
            "backend, init_method=..., world_size=..., rank=...) first")
    axis_sizes = tuple(int(n) for n in axis_sizes)
    n = math.prod(axis_sizes)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    names = tuple(axis_names)
    if ranks is None:
        world = dist.get_world_size()
        if world != n:
            raise RuntimeError(
                f"mesh {axis_sizes} needs {n} processes, found {world} in "
                "the process group: launch one process a mesh position")
        dm = init_device_mesh(device_type, axis_sizes, mesh_dim_names=names)
    else:
        if len(ranks) != n:
            raise ValueError(f"mesh {axis_sizes} needs {n} ranks, got "
                             f"{len(ranks)}")
        dm = DeviceMesh(device_type,
                        torch.tensor(list(ranks)).reshape(axis_sizes),
                        mesh_dim_names=names)
    return ProcessMesh(dm)


# --------------------------------------------------------------- shardings


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout (JAX's ``NamedSharding``): ``spec`` over ``mesh``."""

    mesh: Any
    spec: PartitionSpec

    def entries(self, ndim: int) -> Tuple[AxisVal, ...]:
        parts = tuple(self.spec)
        if len(parts) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"tensor's {ndim} dims")
        return parts + (None,) * (ndim - len(parts))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one mesh position's slice of a ``shape`` tensor."""
        out = []
        for dim, entry in zip(shape, self.entries(len(shape))):
            n = _mesh_size(self.mesh, entry)
            if dim % n:
                raise ValueError(f"dim {dim} does not split over {entry} "
                                 f"(size {n})")
            out.append(dim // n)
        return tuple(out)

    @property
    def replication(self) -> int:
        """How many mesh positions hold each slice."""
        used = {a for e in self.spec for a in _axes_of(e)
                if a in self.mesh.axis_names}
        return math.prod(n for a, n in self.mesh.shape.items()
                         if a not in used)

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: ``Shard(d)`` where the spec
        names that axis at tensor dim d, else ``Replicate()``. DTensor
        splits a tensor dim over several mesh dims in mesh order, so a
        tuple of axes out of the mesh's order has no placements."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.axis_names)
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            idx = [names.index(a) for a in _axes_of(entry) if a in names]
            if idx != sorted(idx):
                raise ValueError(f"{entry} at dim {d} is not in the mesh's "
                                 f"axis order {tuple(names)}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def _chunk(self, entry: AxisVal, coords: Dict[str, int]) -> int:
        idx = 0
        for a in _axes_of(entry):
            if a in self.mesh.axis_names:
                idx = idx * self.mesh.shape[a] + coords[a]
        return idx

    def index(self, shape: Sequence[int], coords=None) -> Tuple[slice, ...]:
        """The slice of a ``shape`` tensor at the mesh position ``coords``
        (default: this process's), JAX's device -> index order."""
        coords = self.mesh.coords if coords is None else coords
        out = []
        for dim, entry, n in zip(shape, self.entries(len(shape)),
                                 self.shard_shape(shape)):
            i = self._chunk(entry, coords)
            out.append(slice(i * n, (i + 1) * n) if n != dim
                       else slice(None))
        return tuple(out)

    def local(self, full, coords=None):
        """This position's slice of the full tensor (or numpy array), a
        view."""
        return full[self.index(full.shape, coords)]


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
    *,
    guard_report: Optional[List[str]] = None,
    tensor_name: str = "",
) -> PartitionSpec:
    """PartitionSpec for one tensor, applying the divisibility guard and
    ensuring no mesh axis is consumed twice."""
    used: set = set()
    parts = []
    for dim, logical in zip(shape, logical_axes):
        axis = _present(mesh, rules.lookup(logical))
        if axis is None:
            parts.append(None)
            continue
        axis_tuple = (axis,) if isinstance(axis, str) else tuple(axis)
        if any(a in used for a in axis_tuple):
            parts.append(None)
            continue
        size = _mesh_size(mesh, axis)
        if size <= 1:
            parts.append(None)
            continue
        if dim % size != 0:
            if guard_report is not None:
                guard_report.append(
                    f"{tensor_name}: dim {dim} (logical '{logical}') not "
                    f"divisible by mesh axis {axis} (size {size}); replicated")
            parts.append(None)
            continue
        parts.append(axis)
        used.update(axis_tuple)
    return PartitionSpec(*parts)


def _sorted_walk(tree, leaf_fn, *rest):
    """``leaf_fn`` over the leaves of nested dicts in sorted key order (the
    order JAX flattens a dict in, which the guard report follows)."""
    if isinstance(tree, dict):
        return {k: _sorted_walk(tree[k], leaf_fn, *(r[k] for r in rest))
                for k in sorted(tree)}
    return leaf_fn(tree, *rest)


def make_param_shardings(
    spec_tree,
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
    *,
    guard_report: Optional[List[str]] = None,
):
    """NamedSharding tree for a ParamSpec tree."""

    def one(s) -> NamedSharding:
        axes = s.axes if s.axes else (None,) * len(s.shape)
        spec = logical_to_spec(axes, s.shape, mesh, rules,
                               guard_report=guard_report,
                               tensor_name="x".join(map(str, s.shape)))
        return NamedSharding(mesh, spec)

    return _sorted_walk(spec_tree, one)


def shardings_from_axes_tree(
    axes_tree,
    shape_tree,
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
    *,
    guard_report: Optional[List[str]] = None,
):
    """NamedShardings for a tree given parallel axes / shape trees (caches
    and batches): axes leaves are tuples (or None: replicated), shape
    leaves anything with a ``shape`` (meta tensors)."""

    def one(axes, sds) -> NamedSharding:
        shape = tuple(sds.shape)
        axes = axes if axes is not None else (None,) * len(shape)
        spec = logical_to_spec(axes, shape, mesh, rules,
                               guard_report=guard_report,
                               tensor_name="x".join(map(str, shape)))
        return NamedSharding(mesh, spec)

    return _sorted_walk(axes_tree, one, shape_tree)


def batch_sharding(mesh, shape: Sequence[int],
                   rules: ShardingRules = DEFAULT_RULES,
                   batch_dim: int = 0) -> NamedSharding:
    """Shard only the batch dim of an activation/batch tensor (guarded:
    a batch that does not divide the data axes replicates, e.g. batch=1
    long-context decode)."""
    axis = _present(mesh, rules.lookup("batch"))
    parts: list = [None] * len(shape)
    if axis is not None and shape[batch_dim] % _mesh_size(mesh, axis) == 0:
        parts[batch_dim] = axis
    return NamedSharding(mesh, PartitionSpec(*parts))


def tile_batch_sharding(mesh, axis: str = TILE_AXIS) -> NamedSharding:
    """NamedSharding for a stacked tile batch: leading (tile) dim over
    ``axis``, tile contents replicated (`LocalMesh` or a 2-D mesh)."""
    return NamedSharding(mesh, PartitionSpec(axis))


def logits_constraint(mesh, rules: ShardingRules = DEFAULT_RULES):
    """The JAX package's layout constraint on (B, S, V) logits (batch over
    ("pod", "data"), vocab over "model"): the port's steps compute the
    full vocab on each rank's rows, so the hook is the identity on values."""
    del mesh, rules
    return lambda x: x


def activation_constraint(mesh, rules: ShardingRules = DEFAULT_RULES,
                          *, sequence_parallel: bool = False):
    """The JAX package's layout constraint on (B, S, d) residual-stream
    activations; the identity on values here (each rank computes its own
    batch rows whole: no sequence or tensor parallelism)."""
    del mesh, rules, sequence_parallel
    return lambda x: x


# ------------------------------------------------------------- collectives


def _staged(t: torch.Tensor, group) -> bool:
    """Gloo has no CUDA all-gather: its CUDA tensors go through the host."""
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """A new tensor: ``t`` reduced (``"sum"`` or ``"max"``) over ``group``
    (``t`` itself when the group is None)."""
    import torch.distributed as dist

    if group is None:
        return t
    x = t.detach().to("cpu", copy=True) if _staged(t, group) \
        else t.detach().clone()
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    return x.to(t.device)


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    import torch.distributed as dist

    x = t.detach().contiguous()
    if _staged(x, group):
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return [p.to(t.device) for p in parts]


def gather(x: torch.Tensor, sharding: NamedSharding,
           dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The tensor whose slice ``x`` is, gathered along ``dims`` (default:
    every sharded dim) from the mesh positions that hold its other slices;
    ``x`` itself where nothing is to gather."""
    import torch.distributed as dist

    mesh = sharding.mesh
    entries = sharding.entries(x.ndim)
    if dims is None:
        dims = [d for d, e in enumerate(entries) if e is not None]
    axes = [a for d in dims for a in _axes_of(entries[d])]
    group = mesh.group(axes) if axes else None
    if group is None:
        return x
    parts = _all_gather(x, group)
    shape = list(x.shape)
    for d in dims:
        shape[d] *= _mesh_size(mesh, entries[d])
    out = x.new_empty(shape)
    for i, part in enumerate(parts):
        coords = mesh.coords_of(dist.get_global_rank(group, i))
        idx = [slice(None)] * x.ndim
        for d in dims:
            c = sharding._chunk(entries[d], coords)
            idx[d] = slice(c * x.shape[d], (c + 1) * x.shape[d])
        out[tuple(idx)] = part
    return out


def reshard(x: torch.Tensor, src: NamedSharding,
            dst: NamedSharding) -> torch.Tensor:
    """This position's slice on ``dst`` of the tensor whose slice on
    ``src`` is ``x`` (same mesh): gathers only the dims whose layout
    changes from sharded, slices the ones that become sharded."""
    es, ed = src.entries(x.ndim), dst.entries(x.ndim)
    gdims = [d for d in range(x.ndim) if es[d] is not None and es[d] != ed[d]]
    y = gather(x, src, gdims) if gdims else x
    idx = [slice(None)] * x.ndim
    for d in range(x.ndim):
        if ed[d] is not None and (es[d] is None or d in gdims):
            n = y.shape[d] // _mesh_size(dst.mesh, ed[d])
            c = dst._chunk(ed[d], dst.mesh.coords)
            idx[d] = slice(c * n, (c + 1) * n)
    return y[tuple(idx)]


def shard_tree(tree, shardings, device=None):
    """Each full leaf (tensor or numpy array) -> this position's slice on
    its sharding, a tensor of its own (on ``device`` when given)."""
    def one(x, s):
        y = s.local(x)
        if isinstance(y, np.ndarray):
            y = torch.from_numpy(np.array(y))
        elif y.numel() != x.numel():
            y = y.clone()
        return y if device is None else y.to(device)

    return tree_map(one, tree, shardings)


def gather_tree(tree, shardings):
    """Each leaf (this position's slice) -> the full tensor (`gather`)."""
    return tree_map(gather, tree, shardings)


def reshard_tree(tree, src, dst):
    return tree_map(reshard, tree, src, dst)


# -------------------------------------------------- global-batch reductions


class _GlobalSum(torch.autograd.Function):
    """All-reduce SUM forward; identity backward: every rank holds the same
    global value, and each rank's gradient then covers its own rows (the
    per-rank parameter gradients are summed afterwards)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class BatchReduce:
    """The reductions over the global batch that a split batch needs (the
    ranks along ``axes`` hold different rows)."""

    def __init__(self, mesh, axes: Sequence[str]):
        self.group = mesh.group(axes)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _GlobalSum.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x.detach(), "max", self.group)


_BATCH_REDUCE: Optional[BatchReduce] = None


def batch_reduce() -> Optional[BatchReduce]:
    """The reductions of the running meshed step (None outside one or when
    its batch is not split). A module global, not a context variable: the
    backward's recomputation of checkpointed layers runs on autograd's
    device threads."""
    return _BATCH_REDUCE


@contextlib.contextmanager
def batch_reduction(red: Optional[BatchReduce]):
    global _BATCH_REDUCE
    prev, _BATCH_REDUCE = _BATCH_REDUCE, red
    try:
        yield red
    finally:
        _BATCH_REDUCE = prev


def sharded_global_norm(grads, shardings) -> torch.Tensor:
    """`repro_torch.optim.optimizers.global_norm` of the full gradients
    from each rank's slices: each leaf's float64 sum of squares over its
    slice, divided by how many positions hold that slice, all-reduced over
    the mesh, then summed and rounded once."""
    from repro_torch.optim.optimizers import sq_sum

    mesh = None
    parts = []
    for g, s in zip(tree_leaves(grads),
                    tree_leaves(tree_map(lambda g, s: s, grads, shardings))):
        mesh = s.mesh
        parts.append(sq_sum(g) / s.replication)
    total = torch.stack(parts)
    total = all_reduce(total, "sum", mesh.group(mesh.axis_names))
    return torch.sqrt(total.sum(0)).float()


# ------------------------------------------------------- FSDP: a layer at use


_gathered_lock = threading.Lock()
_gathered = {"alive": 0, "peak": 0}


def _release(nbytes: int) -> None:
    with _gathered_lock:
        _gathered["alive"] -= nbytes


def _track(t: torch.Tensor) -> None:
    """Count ``t``'s bytes as gathered until its storage is freed."""
    nbytes = t.numel() * t.element_size()
    with _gathered_lock:
        _gathered["alive"] += nbytes
        _gathered["peak"] = max(_gathered["peak"], _gathered["alive"])
    weakref.finalize(t.untyped_storage(), _release, nbytes)


def gathered_bytes() -> Dict[str, int]:
    """{"alive", "peak"}: bytes of gathered parameters and of full gradients
    being reduced that this process holds now, and the most it held at once
    since `reset_gathered_peak`."""
    with _gathered_lock:
        return dict(_gathered)


def reset_gathered_peak() -> None:
    with _gathered_lock:
        _gathered["peak"] = _gathered["alive"]


def _slice_at(x: torch.Tensor, sharding: NamedSharding, dims,
              coords=None) -> torch.Tensor:
    """The chunk of ``x`` (full along ``dims``) that the mesh position
    ``coords`` (default: this process's) holds along those dims."""
    coords = sharding.mesh.coords if coords is None else coords
    entries = sharding.entries(x.ndim)
    idx = [slice(None)] * x.ndim
    for d in dims:
        n = x.shape[d] // _mesh_size(sharding.mesh, entries[d])
        c = sharding._chunk(entries[d], coords)
        idx[d] = slice(c * n, (c + 1) * n)
    return x[tuple(idx)]


def _reduce_scatter(x: torch.Tensor, sharding: NamedSharding, dims,
                    group) -> torch.Tensor:
    """This position's chunk along ``dims`` of the sum of ``x`` over
    ``group`` (whose ranks hold the other chunks): one reduce-scatter (gloo
    has one on CPU tensors; a CUDA tensor goes through the host there)."""
    import torch.distributed as dist

    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.detach()
    mesh = sharding.mesh
    chunks = [_slice_at(src, sharding, dims,
                        mesh.coords_of(dist.get_global_rank(group, i)))
              .contiguous() for i in range(dist.get_world_size(group))]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(x.device)


def reduce_to_slice(g: torch.Tensor, sharding: NamedSharding,
                    batch_axes: Sequence[str]) -> torch.Tensor:
    """The gradient of this position's slice on ``sharding``, from ``g``,
    the full gradient of this rank's rows of a batch split over
    ``batch_axes``: summed over the batch ranks, and only this slice kept.
    Dims sharded over axes that do not split the batch are sliced locally
    (those ranks hold the same rows, hence the same gradient); dims sharded
    over batch axes alone take one reduce-scatter over those axes; the
    batch axes on which the leaf is replicated (and a dim that mixes the
    two kinds) take an all-reduce, then the slice."""
    mesh = sharding.mesh
    batch = {a for a in batch_axes if a in mesh.axis_names}
    entries = sharding.entries(g.ndim)
    local, scatter, mixed = [], [], []
    for d, e in enumerate(entries):
        axes = [a for a in _axes_of(e) if a in mesh.axis_names]
        if not axes:
            continue
        kind = {a in batch for a in axes}
        (scatter if kind == {True} else local if kind == {False}
         else mixed).append(d)
    y = _slice_at(g, sharding, local) if local else g
    scatter_axes = {a for d in scatter for a in _axes_of(entries[d])}
    group = mesh.group(sorted(scatter_axes)) if scatter else None
    if group is not None:
        y = _reduce_scatter(y, sharding, scatter, group)
    elif scatter:
        y = _slice_at(y, sharding, scatter)
    rest = mesh.group(sorted(batch - scatter_axes)) \
        if batch - scatter_axes else None
    if rest is not None:
        y = all_reduce(y, "sum", rest)
    return _slice_at(y, sharding, mixed) if mixed else y


class _GatherAtUse(torch.autograd.Function):
    """Forward: the full tensor of a slice (`gather`). Backward: the
    gradient of the slice (`reduce_to_slice`)."""

    @staticmethod
    def forward(ctx, x, sharding, batch_axes):
        ctx.sharding, ctx.batch_axes = sharding, batch_axes
        y = gather(x, sharding)
        if y is x:
            return x.view_as(x)
        _track(y)
        return y

    @staticmethod
    def backward(ctx, g):
        if g.shape != ctx.sharding.shard_shape(g.shape):
            _track(g)
        return reduce_to_slice(g, ctx.sharding, ctx.batch_axes), None, None


def gather_at_use(x: torch.Tensor, sharding: NamedSharding,
                  batch_axes: Sequence[str] = ()) -> torch.Tensor:
    """The full tensor of the slice ``x`` on ``sharding``; its gradient is
    the slice's gradient of a batch split over ``batch_axes``
    (`reduce_to_slice`)."""
    return _GatherAtUse.apply(x, sharding, tuple(batch_axes))


def _layer_sharding(s: NamedSharding, ndim: int) -> NamedSharding:
    """The sharding of one layer of a leaf stacked over a leading layer
    axis, which no rule shards."""
    entries = s.entries(ndim + 1)
    if entries[0] is not None:
        raise ValueError(f"a stacked leaf's layer axis is sharded ({s.spec})")
    return NamedSharding(s.mesh, PartitionSpec(*entries[1:]))


class LayerGather:
    """What a meshed step's model calls on a tree of parameter slices where
    it uses them (`repro_torch.models.lm`): each leaf gathered with
    `gather_at_use` on its sharding in ``shardings`` (the params' tree),
    the gradients reduced over ``batch_axes``."""

    def __init__(self, shardings, batch_axes: Sequence[str] = ()):
        self.shardings = shardings
        self.batch_axes = tuple(batch_axes)

    def sharding(self, *path: str, stacked: bool = False, ndim: int = 0):
        """The sharding at ``path`` (a unit name ``"attn/wq"`` counts as two
        keys), of one layer of it with ``stacked`` (``ndim``: the layer's)."""
        s = self.shardings
        for key in path:
            for part in key.split("/"):
                s = s[part]
        return _layer_sharding(s, ndim) if stacked else s

    def __call__(self, tree, *path: str, stacked: bool = False,
                 skip: Sequence[str] = ()):
        """``tree`` (the subtree at ``path``; one layer of it with
        ``stacked``) with every leaf gathered, but the leaves at the unit
        names in ``skip`` (``"attn/wq"``, relative to ``path``), passed on
        as they are. Leaves keyed by unit names are found the same way."""
        def walk(node, rel):
            if isinstance(node, dict):
                return {k: walk(v, rel + (k,)) for k, v in node.items()}
            if not isinstance(node, torch.Tensor) \
                    or "/".join(rel) in skip:
                return node
            s = self.sharding(*path, *rel, stacked=stacked, ndim=node.ndim)
            return gather_at_use(node, s, self.batch_axes)

        return walk(tree, ())


_LAYER_GATHER: Optional[LayerGather] = None


def layer_gather() -> Optional[LayerGather]:
    """The running meshed step's `LayerGather` (None outside one). A module
    global, as `batch_reduce`: remat's recompute runs on autograd's
    threads."""
    return _LAYER_GATHER


@contextlib.contextmanager
def layer_gathering(hook: Optional[LayerGather]):
    global _LAYER_GATHER
    prev, _LAYER_GATHER = _LAYER_GATHER, hook
    try:
        yield hook
    finally:
        _LAYER_GATHER = prev
