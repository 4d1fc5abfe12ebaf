"""Full-sequence flash attention: the CUDA kernel
(``flash_attention.flash_attention_cuda``), its plain version
(``ref.attention_reference``) and the device-dispatched, forward-only
entry point ``ops.flash_attention``.  (The entry point is not re-exported
here: its name is the kernel module's.)"""
from repro_torch.kernels.flash_attention import ops, ref  # noqa: F401
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    NoBackwardError,
)
