"""Production meshes on H100s (port of `repro.launch.mesh`).

Exposed as FUNCTIONS (never module-level constants), so importing this
module touches no process group and no card.

The JAX package's 16 x 16 pod (256 chips) and 2 x 16 x 16 (512) do not
carry over. On H100s the mesh follows the interconnect:

  * ``"model"`` carries the tensor-parallel traffic, so it stays inside
    one node's NVLink domain of 8 cards: size 8;
  * ``"data"`` (FSDP and the batch) runs across nodes over the network:
    32 nodes, 256 cards, the JAX package's single-pod device count;
  * ``"pod"`` runs across clusters: 2, 512 cards, its multi-pod count.

So ``("data", "model")`` = (32, 8) single-cluster and ``("pod", "data",
"model")`` = (2, 32, 8) across two. One process drives each card.
"""

from __future__ import annotations

import math

PRODUCTION_SHAPE = (32, 8)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 32, 8)
MULTI_POD_AXES = ("pod", "data", "model")


def production_mesh_layout(*, multi_pod: bool = False):
    """(axis sizes, axis names) of the production mesh."""
    if multi_pod:
        return MULTI_POD_SHAPE, MULTI_POD_AXES
    return PRODUCTION_SHAPE, PRODUCTION_AXES


def mesh_label(mesh) -> str:
    """``"32x8"`` / ``"2x32x8"``: the mesh's sizes joined by ``x``."""
    return "x".join(str(n) for n in mesh.shape.values())


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False):
    """The (32, 8) ("data", "model") mesh, or (2, 32, 8) ("pod", "data",
    "model") with ``multi_pod``, over the initialized process group (one
    process a card; `RuntimeError` naming the processes it needs when the
    group has another size). ``abstract``: an `AbstractMesh` of that
    shape, no process (the dry run)."""
    from repro_torch.distributed.sharding import AbstractMesh, process_mesh

    shape, axes = production_mesh_layout(multi_pod=multi_pod)
    if abstract:
        return AbstractMesh(shape, axes)
    import torch.distributed as dist

    n = math.prod(shape)
    found = dist.get_world_size() if dist.is_initialized() else 1
    if found != n:
        raise RuntimeError(
            f"mesh {shape} needs {n} processes, found {found} — launch one "
            "process a card over the cluster (torch.distributed."
            "init_process_group), or pass abstract=True (dry-run)")
    return process_mesh(shape, axes)


def make_host_mesh(*, model_parallel: int = 1):
    """("data", "model") mesh over the initialized process group's ranks
    (tests, examples): ``world / model_parallel`` x ``model_parallel``."""
    from repro_torch.distributed.sharding import process_mesh

    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs torch.distributed.init_process_group("
            "...) first (one process a mesh position)")
    n = dist.get_world_size()
    assert n % model_parallel == 0, (n, model_parallel)
    return process_mesh((n // model_parallel, model_parallel),
                        ("data", "model"))
