"""Distribution (port of `repro.distributed`): the device meshes and the
logical-axis sharding rules (`sharding`), elastic restore onto any mesh
(`elastic`), the process launcher of the meshed steps (`spawn`) and the
resilient training loop (`fault`)."""

from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    REQUEST_AXIS,
    SWEEP_AXIS,
    TILE_AXIS,
    AbstractMesh,
    LocalMesh,
    NamedSharding,
    PartitionSpec,
    ProcessMesh,
    ShardingRules,
    process_mesh,
    request_mesh,
    sweep_mesh,
    tile_mesh,
)
