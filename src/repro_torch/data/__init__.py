"""Inference workloads (numpy only)."""
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
