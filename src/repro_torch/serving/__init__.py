"""Continuous-batching compressed serving engine and the multi-plan fleet
router (port of `repro.serving`)."""

from repro_torch.serving.bucketing import (  # noqa: F401
    BucketSpec,
    EngineConfig,
    bucket_for,
    bucket_up,
    chunk_plan,
    pad_prompts,
)
from repro_torch.serving.cache import (  # noqa: F401
    ChunkStep,
    CompiledStep,
    GroupStep,
    ServeCompileCache,
)
from repro_torch.serving.engine import (  # noqa: F401
    Request,
    RequestBudget,
    RequestResult,
    ServeRequest,
    ServeResult,
    ServingEngine,
)
from repro_torch.serving.fleet import (  # noqa: F401
    FleetRouter,
    PlanHandle,
    PlanRegistry,
    RouterConfig,
    comp_fingerprint,
)
from repro_torch.serving.metrics import (  # noqa: F401
    RequestStats,
    per_token_energy,
    percentile,
    summarize,
)
