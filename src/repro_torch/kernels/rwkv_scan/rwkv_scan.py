"""Hand-written Hopper kernel for the WKV6 recurrence (CUDA C++,
``sm_90a``): ``wkv6_cuda`` runs ``csrc/wkv6.cu``, which replaces the TPU
kernel ``repro/kernels/rwkv_scan/rwkv_scan.py::wkv6_chunked``
(``_wkv_kernel``) and adds the initial state ``s0`` that the TPU kernel
lacks.  The kernel is a column-split scan: each CTA owns ``columns(B, H,
D)`` value columns of one head's state, fed by a producer warp through a
2-stage cp.async ring (the source's head note has the design).

It takes the projections' own layout, r/k/v/w ``(B, S, H, D)``, so no
transpose is needed around it; any ``S >= 1`` (it runs token by token,
so no chunk size applies), ``D`` in ``HEAD_DIMS``.

The wrapper checks device, dtype, shape, contiguity and 16-byte
alignment and raises on anything the kernel does not take; launches on
``torch.cuda.current_stream()``; allocates only its outputs; never
synchronises; and raises if the launch reports an error.  Its
``launches`` attribute counts the launches it made.  The kernel is built
from the source on first call (``kernels.cuda_build``).  The plain
versions are in ``ref``; ``ops`` dispatches between them by the tensors'
device.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import check_tensor

SRC = Path(__file__).parent / "csrc" / "wkv6.cu"

HEAD_DIMS = (8, 32, 64)        # the reduced config, the JAX sweep, RWKV6-7B


def build_all() -> None:
    """Compile and load this module's kernel."""
    cuda_build.build([SRC])
    cuda_build.c_function(SRC, "wkv6_forward", 8, 4)


@functools.lru_cache(maxsize=1024)
def columns(B: int, H: int, D: int) -> int:
    """Columns of each head's state per CTA that the kernel picks for B
    rows of H heads of dim D: its C entry's own rule (0 for a D it does
    not take)."""
    f = cuda_build.load(SRC).wkv6_columns
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_int
    return f(B, H, D)


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, D) fp32; u (H, D) fp32; s0 (B, H, D, D) fp32
    or None (zeros) -> (y (B, S, H, D), S_last (B, H, D, D)), both fp32."""
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_tensor(name, t, dev, torch.float32, 4)
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    B, S, H, D = r.shape
    check_tensor("u", u, dev, torch.float32, 2)
    if u.shape != (H, D):
        raise ValueError(f"u {tuple(u.shape)} is not (H, D) = {(H, D)}")
    if s0 is not None:
        check_tensor("s0", s0, dev, torch.float32, 4)
        if s0.shape != (B, H, D, D):
            raise ValueError(f"s0 {tuple(s0.shape)} is not (B, H, D, D) = "
                             f"{(B, H, D, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if min(B, S, H) < 1 or B * H > 2 ** 31 - 1:
        raise ValueError(f"(B, S, H) = {(B, S, H)}: empty, or beyond the "
                         "grid")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("s0", s0)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    y = torch.empty_like(r)
    s_last = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    fn = cuda_build.c_function(SRC, "wkv6_forward", 8, 4)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        wkv6_cuda.launches += 1
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), s_last.data_ptr(), B, S, H, D, stream)
    cuda_build.raise_on(err, "wkv6")
    return y, s_last


wkv6_cuda.launches = 0
