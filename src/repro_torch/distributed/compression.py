"""Int8 error-feedback gradient compression for cross-pod reduction:
``repro.distributed.compression`` for the port.

Gradients crossing the slowest links are quantized to int8 with
per-tensor scales.  The quantization error is fed back into the next
step's gradient (error feedback): the residual state satisfies
err_t = (g_t + err_{t-1}) - Q(g_t + err_{t-1}), and the long-run bias of
the compressed sum is bounded by one step's quantization error.

The arithmetic is JAX's: ``torch.round`` rounds half to even as
``jnp.round`` does, and ``compressed_psum`` sums the int32 values times
their scale in fp32 across the axis, then divides by the axis size.
Trees are nested dicts of tensors.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed.context import psum
from repro_torch.training.optimizer import tree_map


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def compress_with_feedback(grads: Any, err: Any) -> Tuple[Any, Any, Any]:
    """Returns (quantized tree of (q, scale), new_err, decompressed)."""
    def one(g, e):
        x = g.float() + e
        q, scale = _quantize(x)
        deq = _dequantize(q, scale)
        return (q, scale), x - deq, deq

    out = tree_map(one, grads, err)
    return (tree_map(lambda o: o[0], out),
            tree_map(lambda o: o[1], out),
            tree_map(lambda o: o[2], out))


def compressed_psum(grads: Any, err: Any, axis_name: str) -> Tuple[Any, Any]:
    """All-reduce int8-compressed gradients over mesh axis ``axis_name``
    of the ambient mesh: quantize -> psum(int32 x scale) -> divide by the
    axis size.  Returns (reduced grads fp32, new error state)."""
    def one(g, e):
        x = g.float() + e
        q, scale = _quantize(x)
        new_e = x - _dequantize(q, scale)
        total = psum(q.to(torch.int32) * scale, axis_name)
        n = psum(torch.ones((), dtype=torch.float32, device=x.device),
                 axis_name)
        return total / n, new_e

    out = tree_map(one, grads, err)
    return (tree_map(lambda o: o[0], out),
            tree_map(lambda o: o[1], out))
