"""Assigned architecture configs (--arch <id>) + input-shape registry."""

from repro_torch.configs.base import (  # noqa: F401
    ALL_ARCHS,
    SHAPES,
    Shape,
    cell_is_runnable,
    get_config,
    skip_reason,
)
