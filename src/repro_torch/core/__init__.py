"""Paper core: scheduling, cache management, cost models (a copy of
``repro.core``'s modules; ``csp``, ``slo`` and the simulation loop are
not part of this port yet)."""
from repro_torch.core.cost_model import (  # noqa: F401
    HARDWARE,
    BatchSpec,
    CostModel,
    HardwareConfig,
    LinearCostModel,
    TheoreticalCostModel,
    calibrated_cost_model,
    fit_linear_model,
    get_hardware,
    profile_synthetic,
)
from repro_torch.core.five_minute_rule import break_even_interval, break_even_table  # noqa: F401
from repro_torch.core.histogram import OutputLengthHistogram  # noqa: F401
from repro_torch.core.kvcache import (  # noqa: F401
    OutOfPagesError,
    PagedAllocator,
    PrefixCache,
    RadixPrefixRegistry,
    attach_prefix_run,
    chain_keys,
)
from repro_torch.core.policies import (  # noqa: F401
    BeladyOraclePolicy,
    BreakEvenPolicy,
    LRUPolicy,
    ReplacementPolicy,
    belady_future_from_requests,
    group_requests,
    make_replacement_policy,
    select_victim,
)
from repro_torch.core.request import Phase, Request  # noqa: F401
from repro_torch.core.scheduler import (  # noqa: F401
    Batch,
    Scheduler,
    SchedulerConfig,
    make_scheduler,
)
from repro_torch.core.simulator import BatchLog, SimResult  # noqa: F401
