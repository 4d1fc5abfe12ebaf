"""Hand-written Hopper kernel for full-sequence flash attention (CUDA C++,
``sm_90a``): ``flash_attention_cuda`` runs ``csrc/flash_attention.cu``,
which replaces the TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd``.

It takes the projection's own layout, q ``(B, S, H, D)`` and k/v
``(B, S, Hkv, D)`` (head ``h = kv_head * G + g``), so no transpose is
needed around it, and it masks keys at positions ``>= S`` instead of
padding ``S`` to a block multiple.

The wrapper checks device, dtype, shape, contiguity and alignment and
raises on anything the kernel does not take; launches on
``torch.cuda.current_stream()``; allocates only its output; never
synchronises; and raises if the launch reports an error.  Its
``launches`` attribute counts the launches it made, and
``launches_by_variant`` splits them by the kernel the dtype selects:
``"wgmma"`` (bf16, tensor cores over ``kernels/common/csrc/
hopper_attention.cuh``) and ``"mma_3xtf32"`` (fp32, ``mma.sync``
tensor-core products in 3xTF32 over ``kernels/common/csrc/
tf32_attention.cuh``).  The kernel is built
from the source on first call (``kernels.cuda_build``).  The plain
version is in ``ref``; ``ops`` dispatches between the two by the
tensors' device.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import check_tensor

SRC = Path(__file__).parent / "csrc" / "flash_attention.cu"

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel each dtype runs, as the C entry chooses it
_VARIANT = {torch.float32: "mma_3xtf32", torch.bfloat16: "wgmma"}


def build_all() -> None:
    """Compile and load this module's kernel."""
    cuda_build.build([SRC])
    cuda_build.c_function(SRC, "flash_attention", 4, 9)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, S, Hkv, D), all of one dtype (fp32 or
    bf16), H a multiple of Hkv -> (B, S, H, D) in q's dtype."""
    dev, dtype = q.device, q.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"q: dtype {dtype} not in {list(_DTYPE_CODE)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, dev, dtype, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} kv heads")
    if window < 0 or prefix_len < 0:
        raise ValueError(f"window {window} / prefix_len {prefix_len} < 0")
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"batch {B} / kv heads {Hkv} beyond the grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = cuda_build.c_function(SRC, "flash_attention", 4, 9)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        flash_attention_cuda.launches += 1
        flash_attention_cuda.launches_by_variant[_VARIANT[dtype]] += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, Hkv, H // Hkv, D, int(bool(causal)), int(window),
                 int(prefix_len), _DTYPE_CODE[dtype], stream)
    cuda_build.raise_on(err, "flash_attention")
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_variant = {"wgmma": 0, "mma_3xtf32": 0}
