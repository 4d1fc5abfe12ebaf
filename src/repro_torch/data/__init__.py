"""Data substrate: synthetic token pipeline + inference workloads (numpy
only)."""
from repro_torch.data.synthetic import (  # noqa: F401
    DataConfig,
    batch_for_step,
    batch_with_frontend,
    data_iterator,
)
from repro_torch.data.workloads import (  # noqa: F401
    GROUPS,
    azureconv_like,
    conversation_tree,
    fixed_grid,
    hetero_mix,
    longform_like,
    shared_prefix,
    zipf_shared_prefix,
)
