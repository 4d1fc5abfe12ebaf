"""The WKV6 recurrence of RWKV6: the CUDA kernel (``rwkv_scan.wkv6_cuda``),
its plain versions (``ref.wkv6_reference``, the per-token oracle, and
``ref.wkv6_chunked_ref``, the JAX model's closed chunked form) and the
device-dispatched, forward-only entry point ``ops.wkv6``."""
from repro_torch.kernels.rwkv_scan import ops, ref  # noqa: F401
from repro_torch.kernels.rwkv_scan.ops import wkv6  # noqa: F401
from repro_torch.kernels.rwkv_scan.rwkv_scan import wkv6_cuda  # noqa: F401
