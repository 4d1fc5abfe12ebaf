"""Device-dispatched flash attention: the full-sequence path's entry point.

``flash_attention`` runs the hand-written CUDA kernel
(``flash_attention.flash_attention_cuda``) on CUDA tensors and the plain
PyTorch version (``ref.attention_reference``) on CPU tensors -- only
because the tensors lie on the CPU.  On any other device the kernel
wrapper's checks raise; nothing falls back.

It is forward-only, as the TPU kernel is: the JAX package has no
backward for ``flash_attention_bhsd`` (``jax.grad`` through it fails), so
training there runs ``impl="reference"``.  A backward through this
function raises ``NoBackwardError``; no gradient is computed in some
other way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import NoBackwardError
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_reference


class _ForwardOnly(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        kw = dict(causal=causal, window=window, prefix_len=prefix_len)
        if q.device.type == "cpu":
            return attention_reference(q, k, v, **kw)
        return flash_attention_cuda(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad_out):
        raise NoBackwardError(
            "flash_attention is forward-only: the JAX package has no "
            "backward for its TPU kernel either (flash_attention_bhsd); "
            "train with impl='reference'")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0) -> torch.Tensor:
    """q (B,S,H,D); k,v (B,S,Hkv,D) -> (B,S,H,D).  Keys at positions
    >= S are masked (no padding), so the result agrees with
    ``ref.attention_reference`` for every S and option."""
    return _ForwardOnly.apply(q, k, v, bool(causal), int(window),
                              int(prefix_len))
