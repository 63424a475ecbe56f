"""Distribution (port of `repro.distributed`): the 1-D device meshes of one
process (`sharding`) and the resilient training loop (`fault`). The
logical-axis sharding rules and elastic restore (the 2-D half) are not
ported yet: ROADMAP.md item 10."""

from repro_torch.distributed.sharding import (  # noqa: F401
    REQUEST_AXIS,
    SWEEP_AXIS,
    TILE_AXIS,
    LocalMesh,
    request_mesh,
    sweep_mesh,
    tile_mesh,
)
