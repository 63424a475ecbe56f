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

**Tensor parallel over "model".** With the step's rules a `LayerGather`
also names the sub-modules that split their features over the model axes
(`tp_axes`: a decoder or encoder block's attention and dense FFN,
cross-attention, the recurrent mixers, the token table and the read-out,
where the layout shards their heads, hidden width, `inner` channels or
vocabulary there; the MoE's experts, every expert's hidden width and the
shared experts' hidden width, `MOE_SPLITS`): their leaves are gathered
over the other axes only, keeping this rank's chunk (`without_axes`,
`kept_axes`), and `ModelSplit` carries the model group to the model code.
The model-group collectives are autograd functions: `copy_to_model`
(identity forward, SUM backward: once a sub-module, on the input its
column-parallel products share), `reduce_from_model` (SUM forward,
identity backward), `model_sum` (SUM both ways: the SSM's gated norm),
`gather_from_model` (all-gather forward, this rank's chunk of the gradient
backward: the expert outputs; of the ranks' summed gradient with
``summed``: the SSM's projections re-laid out by heads); a MAX over the
model group (exact in any order) takes a split activation's amax
(`ModelSplit.act`) and the cross-entropy's maximum; `tp_matmul` runs a
column- or row-parallel product whose float64 partial sums (under QAT)
are summed across the ranks before the one rounding (a row-parallel
output in its forward, reduce-scattered where each rank keeps its chunk,
the shared input's gradient in `copy_to_model`);
`vocab_lookup` and `vocab_parallel_nll` split the embedding and the
cross-entropy by vocabulary (the unsplit loss takes the same
`vocab_parallel_nll`, its exponentials summed in float64, so the two give
the same bits). `activation_constraint` and
`logits_sharding` are the JAX package's layouts, as this rank's slice.
Every collective counts its result's bytes (`collective_counts`), the
figure the dry run's ``collectives`` predicts.
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


def logits_sharding(mesh, shape: Sequence[int],
                    rules: ShardingRules = DEFAULT_RULES) -> NamedSharding:
    """The JAX package's layout of (B, S, V) logits: batch over ("pod",
    "data"), vocab over "model", each guarded (a dim that does not divide
    its axes replicates)."""
    parts: list = [None] * len(shape)
    for d, logical in ((0, "batch"), (len(shape) - 1, "vocab")):
        axis = _present(mesh, rules.lookup(logical))
        n = _mesh_size(mesh, axis)
        if axis is not None and n > 1 and shape[d] % n == 0:
            parts[d] = axis
    return NamedSharding(mesh, PartitionSpec(*parts))


def activation_constraint(mesh, rules: ShardingRules = DEFAULT_RULES):
    """The JAX package's layout constraint on (B, S, ...) residual-stream
    activations and batch tensors, as this rank's slice of the full
    tensor: its rows (`batch_sharding`)."""
    return lambda x: batch_sharding(mesh, x.shape, rules).local(x)


# ------------------------------------------------------------- collectives


def _staged(t: torch.Tensor, group) -> bool:
    """Gloo has no CUDA all-gather: its CUDA tensors go through the host."""
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


_collectives_lock = threading.Lock()
COLLECTIVE_KINDS = ("all-gather", "reduce-scatter", "all-reduce")
_collectives = {k: {"bytes": 0, "count": 0} for k in COLLECTIVE_KINDS}


def _count(kind: str, nbytes: int) -> None:
    with _collectives_lock:
        _collectives[kind]["bytes"] += int(nbytes)
        _collectives[kind]["count"] += 1


def collective_counts() -> Dict[str, Any]:
    """{kind: {"bytes", "count"}, "total_bytes"}: what this process's
    collectives moved since `reset_collective_counts`, each counted by its
    result's bytes (the gathered tensor, the scattered slice, the reduced
    tensor), as the JAX package's dry run parses XLA's collectives."""
    with _collectives_lock:
        out = {k: dict(v) for k, v in _collectives.items()}
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def reset_collective_counts() -> None:
    with _collectives_lock:
        for v in _collectives.values():
            v["bytes"] = v["count"] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
    _count("all-reduce", _nbytes(x))
    return x.to(t.device)


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    import torch.distributed as dist

    x = t.detach().contiguous()
    if _staged(x, group):
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    _count("all-gather", _nbytes(x) * len(parts))
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
    _count("reduce-scatter", _nbytes(out))
    return out.to(x.device)


def _reduce_kinds(sharding: NamedSharding, ndim: int,
                  batch_axes: Sequence[str]):
    """`reduce_to_slice`'s split of a leaf's dims: (local, scatter, mixed
    dims, the scatter axes, the batch axes left for an all-reduce)."""
    mesh = sharding.mesh
    batch = {a for a in batch_axes if a in mesh.axis_names}
    entries = sharding.entries(ndim)
    local, scatter, mixed = [], [], []
    for d, e in enumerate(entries):
        axes = [a for a in _axes_of(e) if a in mesh.axis_names]
        if not axes:
            continue
        kind = {a in batch for a in axes}
        (scatter if kind == {True} else local if kind == {False}
         else mixed).append(d)
    scatter_axes = {a for d in scatter for a in _axes_of(entries[d])}
    return local, scatter, mixed, scatter_axes, batch - scatter_axes


def reduce_plan(sharding: NamedSharding, shape: Sequence[int],
                batch_axes: Sequence[str]) -> List[Tuple[str, Tuple[int,
                                                                    ...]]]:
    """The collectives `reduce_to_slice` runs on a gradient of ``shape``:
    [(kind, result shape)], in order (no process needed: the dry run's
    count)."""
    mesh = sharding.mesh
    local, scatter, _, scatter_axes, rest = _reduce_kinds(
        sharding, len(shape), batch_axes)
    entries = sharding.entries(len(shape))
    shape = list(shape)
    for d in local + scatter:
        shape[d] //= _mesh_size(mesh, entries[d])
    out = []
    if scatter and _mesh_size(mesh, tuple(sorted(scatter_axes))) > 1:
        out.append(("reduce-scatter", tuple(shape)))
    if rest and _mesh_size(mesh, tuple(sorted(rest))) > 1:
        out.append(("all-reduce", tuple(shape)))
    return out


def reduce_to_slice(g: torch.Tensor, sharding: NamedSharding,
                    batch_axes: Sequence[str]) -> torch.Tensor:
    """The gradient of this position's slice on ``sharding``, from ``g``,
    the full gradient of this rank's rows of a batch split over
    ``batch_axes``: summed over the batch ranks, and only this slice kept.
    Dims sharded over axes that do not split the batch are sliced locally
    (those ranks hold the same rows, hence the same gradient); dims sharded
    over batch axes alone take one reduce-scatter over those axes; the
    batch axes on which the leaf is replicated (and a dim that mixes the
    two kinds) take an all-reduce, then the slice (`reduce_plan`)."""
    mesh = sharding.mesh
    local, scatter, mixed, scatter_axes, rest = _reduce_kinds(
        sharding, g.ndim, batch_axes)
    y = _slice_at(g, sharding, local) if local else g
    group = mesh.group(sorted(scatter_axes)) if scatter else None
    if group is not None:
        y = _reduce_scatter(y, sharding, scatter, group)
    elif scatter:
        y = _slice_at(y, sharding, scatter)
    rest = mesh.group(sorted(rest)) if rest else None
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


def _drop_axes(entry: AxisVal, axes: Sequence[str]) -> AxisVal:
    kept = tuple(a for a in _axes_of(entry) if a not in axes)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def without_axes(s: NamedSharding, axes: Sequence[str]) -> NamedSharding:
    """``s`` with ``axes`` taken out of every entry: the layout, over the
    other axes, of the chunk that this rank holds along ``axes`` (what a
    tensor-parallel unit gathers: its model shard, whole along the rest)."""
    return NamedSharding(s.mesh, PartitionSpec(
        *[_drop_axes(e, axes) for e in s.spec]))


# the sub-modules that split their compute over the model axes when the
# layout shards their defining dim there, and that (leaf, dim): a block's
# attention (heads; an encoder block's too), its cross-attention (heads),
# its dense FFN (mlp), the recurrent mixers (inner: the SSM's in_proj
# columns, the RG-LRU's channels), the token table (vocab) and the untied
# read-out (vocab)
TP_UNITS = {"attn": ("wq", 1), "xattn": ("wq", 1), "mlp": ("w_up", 1),
            "ssm": ("in_proj", 1), "rglru": ("in_proj", 1),
            "embed": ("table", 0), "lm_head": ("w", 1)}
# the leaves of a split unit that it reads whole (gathered over every
# axis), each rank taking the part it needs: the SSM's conv weights, whose
# channels (x | B | C) do not line up with its heads
WHOLE_LEAVES = {"ssm": ("conv_w", "conv_b")}
# the MoE's three splits, each by its defining (leaf, dim): the experts
# over the axes of their E dim (expert parallel), every expert's hidden
# width over those of moe_ff (tensor-parallel experts), the shared
# experts' hidden width over those of mlp (as the dense FFN)
MOE_SPLITS = {"experts": ("w_gate", 0), "expert_ff": ("w_gate", 2),
              "shared": ("shared_up", 1)}
# the splits whose chunk each MoE leaf keeps at use (the router: none)
MOE_LEAVES = {**{k: ("experts", "expert_ff")
                 for k in ("w_gate", "w_up", "w_down")},
              **{k: ("shared",)
                 for k in ("shared_gate", "shared_up", "shared_down")}}


def tp_axes(shardings, path: Sequence[str],
            rules: ShardingRules) -> Tuple[str, ...]:
    """The mesh axes over which the sub-module at ``path`` of a params'
    sharding tree computes this rank's share of its features, () where it
    computes whole. ``path``: ``("blocks", "g0", "attn")``, ``("tail",
    "t0", "mlp")``, ``("enc_blocks", "attn")`` (the encoder's stack),
    ``("blocks", "g0", "xattn")``, ``("blocks", "g0", "ssm")``,
    ``("embed",)``, ``("lm_head",)``, or one of the MoE's splits,
    ``("blocks", "g0", "moe", "experts")`` (`MOE_SPLITS`). A unit splits
    over the axes that shard its defining dim (`TP_UNITS`, after the
    divisibility guard), unless they split the batch too."""
    path = tuple(path)
    if len(path) > 1 and path[-2] == "moe" and path[-1] in MOE_SPLITS:
        sub, (leaf, dim) = path[:-1], MOE_SPLITS[path[-1]]
    elif path and path[-1] in TP_UNITS:
        sub, (leaf, dim) = path, TP_UNITS[path[-1]]
    else:
        return ()
    if len(sub) > 1 and sub[0] not in ("blocks", "tail", "enc_blocks"):
        return ()
    s = shardings
    try:
        for key in (*sub, leaf):
            s = s[key]
    except KeyError:
        return ()
    mesh, spec = s.mesh, tuple(s.spec)
    dim += sub[0] in ("blocks", "enc_blocks")   # the stacked layer axis
    entry = spec[dim] if dim < len(spec) else None
    axes = tuple(a for a in _axes_of(entry) if a in mesh.axis_names)
    batch = set(_axes_of(_present(mesh, rules.lookup("batch"))))
    return () if batch & set(axes) else axes


def kept_axes(shardings, path: Sequence[str],
              rules: ShardingRules) -> Tuple[str, ...]:
    """The mesh axes along which the leaf at ``path`` (``("blocks", "g0",
    "attn", "wq")``) keeps this rank's chunk when a meshed step gathers it:
    its sub-module's `tp_axes`, or, in the MoE, those of the splits the
    leaf takes part in (`MOE_LEAVES`); () where it is gathered whole (a
    leaf of `WHOLE_LEAVES` too)."""
    *sub, key = tuple(path)
    if sub and sub[-1] == "moe":
        return tuple(a for name in MOE_LEAVES.get(key, ())
                     for a in tp_axes(shardings, (*sub, name), rules))
    if sub and key in WHOLE_LEAVES.get(sub[-1], ()):
        return ()
    return tp_axes(shardings, sub, rules)


class LayerGather:
    """What a meshed step's model calls on a tree of parameter slices where
    it uses them (`repro_torch.models.lm`): each leaf gathered with
    `gather_at_use` on its sharding in ``shardings`` (the params' tree),
    the gradients reduced over ``batch_axes``.

    **Tensor-parallel units.** With ``rules`` (the step's), a sub-module of
    `TP_UNITS` whose defining dim the layout shards over mesh axes that do
    not split the batch (after the divisibility guard: "model" by default)
    computes its share of the features on each of those ranks
    (`model_split`): its leaves are gathered over their other axes only,
    each rank keeping its model chunk (`without_axes`), and the model code
    runs it column- or row-parallel (`tp_matmul`). That holds for a
    decoder or encoder block's attention and FFN, cross-attention and the
    recurrent mixers (the SSM's conv weights, `WHOLE_LEAVES`, are gathered
    whole). The MoE splits the same way by `MOE_SPLITS`: its experts
    (expert parallel), every expert's hidden width, its shared experts'
    hidden width, each leaf keeping the chunks of the splits it takes part
    in (`kept_axes`). Every other leaf is gathered whole. Without ``rules``
    every leaf is gathered whole (the storage-only step)."""

    def __init__(self, shardings, batch_axes: Sequence[str] = (), *,
                 rules: Optional[ShardingRules] = None):
        self.shardings = shardings
        self.batch_axes = tuple(batch_axes)
        self.rules = rules
        self.mesh = tree_leaves(shardings)[0].mesh
        self._splits: Dict[tuple, Optional["ModelSplit"]] = {}

    def sharding(self, *path: str, stacked: bool = False, ndim: int = 0):
        """The sharding at ``path`` (a unit name ``"attn/wq"`` counts as two
        keys), of one layer of it with ``stacked`` (``ndim``: the layer's)."""
        s = self.shardings
        for key in path:
            for part in key.split("/"):
                s = s[part]
        return _layer_sharding(s, ndim) if stacked else s

    def model_split(self, *path: str) -> Optional["ModelSplit"]:
        """The `ModelSplit` of the tensor-parallel sub-module (or MoE
        split) at ``path`` (`tp_axes`), or None where it computes whole."""
        if path not in self._splits:
            axes = () if self.rules is None \
                else tp_axes(self.shardings, path, self.rules)
            split = None
            if axes:
                mesh = self.mesh
                split = ModelSplit(
                    axes, mesh.group(axes),
                    NamedSharding(mesh, PartitionSpec())._chunk(
                        axes, mesh.coords), _mesh_size(mesh, axes),
                    BatchReduce(mesh, self.batch_axes + axes), mesh)
            self._splits[path] = split
        return self._splits[path]

    def block_splits(self, *path: str) -> Optional[Dict[str, Any]]:
        """{"attn": split, "xattn": split, "mlp": split, "ssm": split,
        "rglru": split, "moe": {"experts": split, "expert_ff": split,
        "shared": split}} of the block at ``path`` (a decoder block's, or
        ``("enc_blocks",)``, an encoder layer's), what computes whole or is
        not there left out; None where nothing splits."""
        out = {sub: self.model_split(*path, sub)
               for sub in ("attn", "xattn", "mlp", "ssm", "rglru")}
        moe = {name: self.model_split(*path, "moe", name)
               for name in MOE_SPLITS}
        out["moe"] = {k: v for k, v in moe.items() if v is not None} or None
        out = {k: v for k, v in out.items() if v is not None}
        return out or None

    def __call__(self, tree, *path: str, stacked: bool = False,
                 skip: Sequence[str] = ()):
        """``tree`` (the subtree at ``path``; one layer of it with
        ``stacked``) with every leaf gathered, but the leaves at the unit
        names in ``skip`` (``"attn/wq"``, relative to ``path``), passed on
        as they are. Leaves keyed by unit names are found the same way. A
        tensor-parallel sub-module's leaves keep their model chunk
        (`kept_axes`)."""
        def walk(node, rel):
            if isinstance(node, dict):
                return {k: walk(v, rel + (k,)) for k, v in node.items()}
            if not isinstance(node, torch.Tensor) \
                    or "/".join(rel) in skip:
                return node
            s = self.sharding(*path, *rel, stacked=stacked, ndim=node.ndim)
            parts = tuple(p for r in (*path, *rel) for p in r.split("/"))
            axes = () if self.rules is None \
                else kept_axes(self.shardings, parts, self.rules)
            if axes:
                s = without_axes(s, axes)
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


# ------------------------------------------- tensor parallel over "model"


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """A unit's features split over the mesh axes ``axes`` ("model" by
    default): this rank computes chunk ``index`` of ``size`` of them, with
    the ranks of ``group`` (the same rows, the other chunks). ``act``: the
    reductions of an activation split that way (its amax is a MAX over the
    batch ranks and ``group``); ``mesh``: the mesh the axes are of."""

    axes: Tuple[str, ...]
    group: Any
    index: int
    size: int
    act: BatchReduce
    mesh: Any = None

    def chunk(self, n: int) -> Tuple[int, int]:
        """(length, start) of this rank's chunk of ``n`` features."""
        if n % self.size:
            raise ValueError(f"{n} features do not split over {self.axes} "
                             f"(size {self.size})")
        return n // self.size, self.index * (n // self.size)


class _CopyToModel(torch.autograd.Function):
    """Identity forward (every model rank holds ``x``); backward the SUM of
    the ranks' gradients over the model group (each rank's covers only its
    features)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


class _ReadAs(torch.autograd.Function):
    """``value`` in ``src``'s dtype forward; backward the gradient to
    ``src`` unchanged, none to ``value``."""

    @staticmethod
    def forward(ctx, value, src):
        return value.to(src.dtype) if value.dtype != src.dtype \
            else value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _ReduceFromModel(torch.autograd.Function):
    """SUM over the model group forward; identity backward (the sum's
    gradient is each term's)."""

    @staticmethod
    def forward(ctx, x, group):
        y = all_reduce(x, "sum", group)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, split: ModelSplit,
                  exact: bool = False) -> torch.Tensor:
    """``x``, which every model rank of ``split`` holds whole (the input
    that a sub-module's column-parallel products share, or a replicated
    weight whose rows each rank reads its share of): identity forward,
    and backward the SUM over the model ranks, once, of the gradients of
    every product of this rank that reads it. ``exact``: the copy is
    float64, so that those products' float64 gradients (`tp_matmul`) are
    summed, over the products and then the ranks, and rounded once (a
    product reads a fake-quantized ``x`` through `read_as`)."""
    return _CopyToModel.apply(x.double() if exact else x, split.group)


def read_as(value: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``value`` (``src`` as a product reads it: fake-quantized, whose
    gradient is the straight-through one) in ``src``'s dtype, with its
    gradient going to ``src`` unchanged."""
    return _ReadAs.apply(value, src)


def reduce_from_model(x: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    return _ReduceFromModel.apply(x, split.group)


def _along(split: ModelSplit, ndim: int, dim: int) -> NamedSharding:
    """The layout of a tensor chunked along ``dim`` over ``split``'s
    axes."""
    parts = [None] * ndim
    parts[dim % ndim] = split.axes
    return NamedSharding(split.mesh, PartitionSpec(*parts))


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the model ranks' chunks along ``dim`` forward. Backward
    this rank's chunk of the gradient: where every model rank computes the
    same function of the gathered tensor, each holds the whole gradient (a
    sum over the ranks would count it ``size`` times); with ``summed``
    the ranks use it differently, and the chunk is that of the SUM of
    their gradients (a reduce-scatter; ``exact``: of their float64
    gradients, rounded once)."""

    @staticmethod
    def forward(ctx, x, split, dim, summed, exact):
        ctx.split, ctx.dim, ctx.summed, ctx.exact = split, dim, summed, exact
        y = gather(x, _along(split, x.ndim, dim), [dim % x.ndim])
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        split, dim = ctx.split, ctx.dim % g.ndim
        if ctx.summed and split.group is not None:
            total = _reduce_scatter(g.to(_sum_dtype(ctx.exact, g)),
                                    _along(split, g.ndim, dim), [dim],
                                    split.group)
            return total.to(g.dtype), None, None, None, None
        n, start = split.chunk(g.shape[dim])
        return g.narrow(dim, start, n), None, None, None, None


def gather_from_model(x: torch.Tensor, split: ModelSplit, dim: int,
                      summed: bool = False,
                      exact: bool = False) -> torch.Tensor:
    """The tensor whose chunk along ``dim`` ``x`` is, put together from the
    model ranks of ``split`` (each holding its chunk, in chunk order).
    ``summed``: the ranks read different parts of it (the SSM's heads), so
    its gradient is summed over them before each keeps its chunk, in
    float64 rounded once where ``exact`` (under QAT, as `tp_matmul`'s
    sums)."""
    return _GatherFromModel.apply(x, split, dim, summed, exact)


class _ModelSum(torch.autograd.Function):
    """SUM over the model group forward, and backward: every rank uses the
    sum for its own features, so the sum's gradient is the ranks' sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = all_reduce(x, "sum", group)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


def model_sum(x: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    """The SUM of ``x`` (each rank's partial, e.g. a sum of squares over its
    features) over the model ranks of ``split``, which each use it for
    their own features: its backward sums their gradients too."""
    return _ModelSum.apply(x, split.group)


def _sum_dtype(exact: bool, g: torch.Tensor) -> torch.dtype:
    return torch.float64 if exact else g.dtype


class _ColumnMatmul(torch.autograd.Function):
    """``x @ w`` of a column-parallel unit: ``x`` (..., K) whole on every
    model rank (the sub-module's `copy_to_model` copy), ``w`` (K, N /
    size) this rank's columns. ``exact``: the product is summed in float64
    and rounded once (`exact_matmul`). The backward's ``x`` gradient is
    this rank's partial sum over its columns, in the sum's own dtype
    (float64 when ``exact``), with no collective: `copy_to_model` sums it
    over the model ranks."""

    @staticmethod
    def forward(ctx, x, w, group, exact):
        ctx.save_for_backward(x, w)
        ctx.exact = exact
        if exact:
            return (x.double() @ w.double()).float()
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.lut_matmul.ref import matmul_grads

        x, w = ctx.saved_tensors
        gx, gw = matmul_grads(x, w, g, _sum_dtype(ctx.exact, g),
                              ctx.needs_input_grad[:2])
        return gx, gw, None, None


class _RowMatmul(torch.autograd.Function):
    """``x @ w`` of a row-parallel unit: ``x`` (..., K / size) this rank's
    features, ``w`` (K / size, N) its rows. Forward: each rank's partial
    sum, all-reduced over the model group (in float64 when ``exact``) and
    rounded once after the SUM; backward: each rank's own gradients (no
    collective)."""

    @staticmethod
    def forward(ctx, x, w, group, exact):
        ctx.save_for_backward(x, w)
        ctx.exact = exact
        y = (x.double() @ w.double()) if exact else torch.matmul(x, w)
        y = all_reduce(y, "sum", group)
        return y.float() if exact else y

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.lut_matmul.ref import matmul_grads

        x, w = ctx.saved_tensors
        gx, gw = matmul_grads(x, w, g, _sum_dtype(ctx.exact, g),
                              ctx.needs_input_grad[:2])
        return gx, gw, None, None


class _RowScatterMatmul(torch.autograd.Function):
    """``x @ w`` of a row-parallel product whose output every rank needs
    only its chunk of (the RG-LRU's gates): ``x`` (..., K / size) and ``w``
    (K / size, N) this rank's share of the reduced dim. Forward: each
    rank's partial sum, reduce-scattered over the model group along N (in
    float64 when ``exact``) and rounded once, this rank's (..., N / size);
    backward: the chunks' gradients all-gathered into the whole (..., N),
    then this rank's gradients of ``x`` and ``w``."""

    @staticmethod
    def forward(ctx, x, w, split, exact):
        ctx.save_for_backward(x, w)
        ctx.split, ctx.exact = split, exact
        y = (x.double() @ w.double()) if exact else torch.matmul(x, w)
        if split.group is not None:
            y = _reduce_scatter(y, _along(split, y.ndim, -1), [y.ndim - 1],
                                split.group)
        return y.float() if exact else y

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.lut_matmul.ref import matmul_grads

        x, w = ctx.saved_tensors
        split = ctx.split
        if split.group is not None:
            g = gather(g.contiguous(), _along(split, g.ndim, -1),
                       [g.ndim - 1])
        gx, gw = matmul_grads(x, w, g, _sum_dtype(ctx.exact, g),
                              ctx.needs_input_grad[:2])
        return gx, gw, None, None


def tp_matmul(x: torch.Tensor, w: torch.Tensor, split: ModelSplit,
              kind: str, exact: bool) -> torch.Tensor:
    """``x @ w`` (``w`` 2-D, or a batch of experts' (E, K, N) against ``x``
    (E, M, K)) of a unit split over ``split``'s ranks:
    ``kind`` ``"column"`` (``w`` this rank's output columns; the result is
    its columns; ``x`` the `copy_to_model` copy of the sub-module's input,
    which sums its gradient over the ranks), ``"row"`` (``x`` and ``w``
    this rank's share of the reduced dim; the result is whole) or
    ``"row_scatter"`` (as ``"row"``, the result this rank's chunk of the
    columns: `_RowScatterMatmul`). ``exact``: float32 out, summed in
    float64 across the ranks too and rounded once, as `exact_matmul`; else
    the operands' dtype, as ``torch.matmul``."""
    if kind == "row_scatter":
        return _RowScatterMatmul.apply(x, w, split, exact)
    fn = {"column": _ColumnMatmul, "row": _RowMatmul}[kind]
    return fn.apply(x, w, split.group, exact)


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 split: ModelSplit) -> torch.Tensor:
    """Rows of this rank's vocabulary chunk ``table`` (V / size, d) for the
    token ids ``tokens``, zeros where another rank owns the id: the SUM of
    the ranks' results (`reduce_from_model`) is the lookup, exactly, one
    rank contributing each row."""
    v = table.shape[0]
    local = tokens.long() - split.index * v
    own = (local >= 0) & (local < v)
    rows = table[local.clamp(0, v - 1)]
    return torch.where(own[..., None], rows, torch.zeros(
        (), dtype=rows.dtype, device=rows.device))


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] over a vocabulary split over the model
    group (whole where ``group`` is None): ``logits`` (..., V / size)
    float32, this rank's chunk starting at id ``start``. The MAX of the
    chunks' maxima, the SUM of the shifted exponentials in float64 (the
    chunks' sums added across the ranks, the log taken once and rounded),
    the label's logit from the rank that owns it (the others add zero),
    then log_softmax's order of operations; backward ``g * (softmax -
    onehot)`` on the chunk, the softmax ``exp`` of that float32 log
    probability. Split or whole, the loss and its gradient are the same
    bits (but where the float64 sum rounds apart)."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        v = logits.shape[-1]
        m = all_reduce(logits.amax(dim=-1), "max", group)
        s = all_reduce(torch.exp(logits - m[..., None]).sum(
            dim=-1, dtype=torch.float64), "sum", group)
        local = labels.long() - start
        own = (local >= 0) & (local < v)
        local = local.clamp(0, v - 1)
        picked = torch.gather(logits, -1, local[..., None])[..., 0]
        picked = all_reduce(torch.where(own, picked,
                                        torch.zeros_like(picked)),
                            "sum", group)
        log_s = torch.log(s).to(logits.dtype)
        ctx.save_for_backward(logits, m, log_s, local, own)
        return -((picked - m) - log_s)

    @staticmethod
    def backward(ctx, g):
        logits, m, log_s, local, own = ctx.saved_tensors
        grad = torch.exp((logits - m[..., None]) - log_s[..., None]) \
            * g[..., None]
        hit = torch.where(own, g, torch.zeros_like(g))
        grad.scatter_add_(-1, local[..., None], -hit[..., None])
        return grad, None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       split: Optional[ModelSplit]) -> torch.Tensor:
    """Per-position negative log-likelihood (..., ) of ``labels`` under
    logits whose vocabulary ``split`` chunks over the model ranks
    (``logits`` this rank's chunk, float32), or, with ``split`` None, the
    whole vocabulary: the same function, so a split loss gives the
    unsplit bits (`_VocabParallelNLL`)."""
    if split is None:
        return _VocabParallelNLL.apply(logits, labels, 0, None)
    start = split.chunk(logits.shape[-1] * split.size)[1]
    return _VocabParallelNLL.apply(logits, labels, start, split.group)
