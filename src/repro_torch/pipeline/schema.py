"""Plan/stage schema constants (port of the constants of
`repro.pipeline.schema`).

The port writes the same format string and schema version as the JAX
package, so each loads the other's plans.
"""

from __future__ import annotations

PLAN_SCHEMA_VERSION = 1
PLAN_FORMAT = "repro.pipeline.plan"

# canonical stage order; `Pipeline` executes a prefix of this tuple
STAGES = ("profile", "energy_model", "schedule", "export", "serve")


def stage_index(name: str) -> int:
    try:
        return STAGES.index(name)
    except ValueError:
        raise ValueError(
            f"unknown stage {name!r}; stages are {', '.join(STAGES)}"
        ) from None
