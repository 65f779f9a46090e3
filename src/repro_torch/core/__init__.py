"""GPAC core, ported: address space, telemetry, filter, consolidator,
host tiering and its N-tier hierarchies, metrics, the engine loop and its
guest-axis sharding."""
from repro_torch.core.types import (  # noqa: F401
    FREE,
    GpacConfig,
    TieredState,
    allocated_hp_mask,
    init_state,
    start_all_far,
)
from repro_torch.core import (  # noqa: F401
    address_space,
    consolidator,
    engine,
    filter,
    gpac,
    metrics,
    sharding,
    telemetry,
    tiering,
    tiers,
)
from repro_torch.core.engine import (  # noqa: F401
    EngineSpec,
    GuestSpec,
    HostSpec,
)
from repro_torch.core.tiers import (  # noqa: F401
    TierSpec,
    TierVector,
)
