"""Device-dispatched WKV6: the RWKV6 time-mix's entry point.

``wkv6`` runs the hand-written CUDA kernel (``rwkv_scan.wkv6_cuda``) on
CUDA tensors and the plain closed chunked form
(``ref.wkv6_chunked_ref``, the JAX model's own arithmetic) on CPU
tensors -- only because the tensors lie on the CPU.  On any other device
the kernel wrapper's checks raise; nothing falls back.

It is forward-only: the JAX package has no backward for its TPU kernel
(``wkv6_chunked``), and trains RWKV through a ``jnp`` scan instead.  So
does the port: ``train_loss`` asks ``models.rwkv`` for
``scan="chunked"``, ``ref.wkv6_chunked_ref`` under autograd, and never
reaches this function.  A backward through it raises
``NoBackwardError``; no gradient is computed in some other way.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import NoBackwardError
from repro_torch.kernels.rwkv_scan.ref import wkv6_chunked_ref
from repro_torch.kernels.rwkv_scan.rwkv_scan import wkv6_cuda


class _ForwardOnly(torch.autograd.Function):

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        if r.device.type == "cpu":
            return wkv6_chunked_ref(r, k, v, w, u, s0, chunk)
        return wkv6_cuda(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, grad_y, grad_s):
        raise NoBackwardError(
            "wkv6 is forward-only: the JAX package has no backward for its "
            "TPU kernel either (wkv6_chunked); training runs the chunked "
            "form (models.rwkv scan='chunked')")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, s0: Optional[torch.Tensor] = None,
         chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, D); u (H, D); s0 (B, H, D, D) or None (zeros)
    -> (y (B, S, H, D) fp32, S_last (B, H, D, D) fp32).  Inputs are cast
    to fp32, as the JAX ``ops.wkv6`` casts them.  ``chunk`` is the closed
    form's chunk on the CPU (it must divide S); the kernel runs token by
    token and ignores it."""
    f32 = lambda t: None if t is None else t.float()  # noqa: E731
    return _ForwardOnly.apply(f32(r), f32(k), f32(v), f32(w), f32(u),
                              f32(s0), int(chunk))
