"""Paper core: scheduling, cache management, cost models, CSP, 5-min rule
(a copy of ``repro.core``'s modules)."""
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
from repro_torch.core.csp import (  # noqa: F401
    CSPResult,
    exists_schedule_below,
    solve_optimal_schedule,
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
from repro_torch.core.simulator import (  # noqa: F401
    BatchLog,
    PrefixTierSim,
    SimResult,
    fresh_requests,
    run_sim,
    simulate,
)
from repro_torch.core.slo import pareto_curve  # noqa: F401
