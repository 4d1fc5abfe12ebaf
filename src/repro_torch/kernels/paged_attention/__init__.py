from repro_torch.kernels.paged_attention import ops, ref  # noqa: F401
from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_decode,
    paged_prefill,
)
from repro_torch.kernels.paged_attention.paged_attention import (  # noqa: F401
    paged_decode_cuda,
    paged_prefill_cuda,
)
