"""Serving layer: continuous-batching engine on the paged data plane, with
the host swap store of its preemption and demotion paths and the step
transactions of its failure model (``serving.txn``, ``serving.faults``)."""
from repro_torch.serving.engine import (  # noqa: F401
    Engine,
    EngineConfig,
    EngineResult,
    generate_reference,
)
from repro_torch.serving.swap_store import (  # noqa: F401
    KVSwapStore,
    PageRunEntry,
    SwapEntry,
    SwapStoreFullError,
)
from repro_torch.serving.paged_plane import (  # noqa: F401
    build_paged_fns,
    paged_supported,
)
from repro_torch.serving.serve_step import (  # noqa: F401
    build_decode_fn,
    build_prefill_chunk_fn,
    build_prefill_fn,
    build_train_fn,
)
