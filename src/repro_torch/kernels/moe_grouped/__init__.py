"""The dropless grouped MoE layer: the Triton kernels
(``moe_grouped.moe_grouped_cuda``), their plain version
(``ref.moe_grouped_reference``) and the device-dispatched, forward-only
entry point ``ops.moe_grouped``."""
from repro_torch.kernels.moe_grouped import ops, ref  # noqa: F401
from repro_torch.kernels.moe_grouped.moe_grouped import (  # noqa: F401
    moe_grouped_cuda,
)
