"""Device-dispatched paged attention: the engine's entry points.

``paged_decode`` / ``paged_prefill`` run the hand-written CUDA kernels
(``paged_attention``) on CUDA tensors and the plain PyTorch versions
(``ref``) on CPU tensors — only because the tensors lie on the CPU.  On
any other device the kernel wrapper's checks raise; nothing falls back.
Both read the same pooled ``(num_pages, page_size, Hkv, D)`` layout
through the same block tables, and ``paged_prefill`` writes the chunk's
rows into the pools in place on either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.paged_attention import (
    paged_decode_cuda, paged_prefill_cuda)
from repro_torch.kernels.paged_attention.ref import (paged_decode_reference,
                                                     paged_prefill_reference)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor,
                 context_lens: torch.Tensor) -> torch.Tensor:
    """q (B,H,D); pools (P, page, Hkv, D); block_tables (B, npages) int32;
    context_lens (B,) int32 -> (B,H,D)."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, block_tables,
                                      context_lens)
    return paged_decode_cuda(q, k_pool, v_pool, block_tables, context_lens)


def paged_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_tables: torch.Tensor, starts: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """q (B,c,H,D); k/v (B,c,Hkv,D); pools (P, page, Hkv, D);
    block_tables (B, maxp) int32; starts/lengths (B,) int32 -> out
    (B,c,H,D).  Writes the chunk's real rows into the pools in place
    (padded rows write nothing) and attends causally over
    [own pages ++ chunk].  Outputs of padded rows are unspecified."""
    if q.device.type == "cpu":
        return paged_prefill_reference(q, k, v, k_pool, v_pool,
                                       block_tables, starts, lengths)
    return paged_prefill_cuda(q, k, v, k_pool, v_pool, block_tables, starts,
                              lengths)
