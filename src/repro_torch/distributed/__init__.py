"""Distribution: sharding rules, collectives, compression, fault
tolerance (``repro.distributed`` on ``torch.distributed``)."""
from repro_torch.distributed.collectives import (  # noqa: F401
    decode_attn_reference,
    flash_decode_seqsharded,
    make_seqsharded_decode_attn,
)
from repro_torch.distributed.compression import (  # noqa: F401
    compress_with_feedback,
    compressed_psum,
    init_error_state,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    StragglerEvent,
    StragglerMonitor,
    elastic_remesh,
    reshard,
    run_with_retries,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    batch_pspecs,
    dp_axes,
    fit_specs,
    named,
    out_pspecs_decode,
    param_pspecs,
)
