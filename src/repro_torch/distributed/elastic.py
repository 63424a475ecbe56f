"""Elastic scaling: restore any checkpoint onto any mesh (port of
`repro.distributed.elastic`).

Checkpoints are host-side numpy (`repro_torch.checkpoint.manager`), so an
elastic restart reduces to: build the new mesh from the processes that are
actually healthy, re-derive the shardings from the (unchanged) logical axis
rules, and let each rank keep its own slice of every host array. The rules
guard on divisibility per tensor, so the same rules give valid placements
at any power-of-two slice of the fleet: a 2 x 32 x 8 job can resume on
32 x 8 or 16 x 8 without code changes.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from repro_torch._device import tree_leaves
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    ProcessMesh,
    ShardingRules,
    process_mesh,
    shard_tree,
)


def available_mesh(model_parallel: int, *, axis_names=("data", "model"),
                   devices: Optional[Sequence[int]] = None) -> ProcessMesh:
    """Largest (data, model) mesh the healthy processes support:
    ``devices`` are their ranks (default: the whole process group), one
    card a process; every rank of the group calls it."""
    import torch.distributed as dist

    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    assert n % model_parallel == 0, (n, model_parallel)
    ranks = ranks[: (n // model_parallel) * model_parallel]
    shape = (n // model_parallel, model_parallel)
    if devices is None:
        return process_mesh(shape, axis_names)
    return process_mesh(shape, axis_names, ranks=ranks)


def elastic_restore(
    ckpt,                       # CheckpointManager
    model,                      # LMModel (for sharding re-derivation)
    mesh,
    *,
    step: Optional[int] = None,
    rules: ShardingRules = DEFAULT_RULES,
) -> tuple[int, Any]:
    """Restore a train state onto ``mesh`` regardless of the mesh it was
    saved under: each rank's slices on `train_state_shardings`."""
    from repro_torch.launch.train import train_state_shardings

    shardings = train_state_shardings(model, mesh, rules)
    return ckpt.restore(step, shardings=shardings)


def reshard(state_host: Any, shardings: Any) -> Any:
    """Each leaf of a host-side state tree (numpy or tensors) -> this rank's
    slice on its sharding, on the mesh's device."""
    devices = {s.mesh.device for s in tree_leaves(shardings)}
    return shard_tree(state_host, shardings,
                      devices.pop() if len(devices) == 1 else None)
