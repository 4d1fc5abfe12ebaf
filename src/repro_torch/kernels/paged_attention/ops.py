"""Device-dispatched paged attention: the engine's entry points.

``paged_decode`` / ``paged_prefill`` run the hand-written CUDA kernels
(``paged_attention``) on CUDA tensors and the plain PyTorch versions
(``ref``) on CPU tensors — only because the tensors lie on the CPU.  On
any other device the kernel wrapper's checks raise; nothing falls back.
Both read the same pooled ``(num_pages, page_size, Hkv, D)`` layout
through the same block tables, and ``paged_prefill`` writes the chunk's
rows into the pools in place on either device.  ``decode_attention_dense``
runs ``paged_decode`` on a contiguous dense cache viewed as pages.
"""
from __future__ import annotations

from typing import Dict, Tuple

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


#: identity block tables by (B, npages, device), built outside any graph
#: capture and reused: a constant of every dense decode step
_IDENTITY_TABLES: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _identity_tables(B: int, npages: int,
                     device: torch.device) -> torch.Tensor:
    """(B, npages) int32: row b maps pages b * npages .. b * npages +
    npages - 1, i.e. its own contiguous run of the viewed cache."""
    key = (B, npages, str(device))
    bt = _IDENTITY_TABLES.get(key)
    if bt is None:
        bt = (torch.arange(B, device=device)[:, None] * npages
              + torch.arange(npages, device=device)[None, :]).to(torch.int32)
        capturing = (device.type == "cuda"
                     and torch.cuda.is_current_stream_capturing())
        if not capturing:       # a capture's tensor lives in its pool
            _IDENTITY_TABLES[key] = bt
    return bt


def decode_attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           context_lens: torch.Tensor, *,
                           page_size: int = 64) -> torch.Tensor:
    """Dense-cache decode through the paged decode kernel (B1): the
    contiguous cache (B, S, Hkv, D) is viewed, without a copy, as a pool
    of ``B * S / page_size`` pages of ``page_size`` tokens, and row b
    reads its own pages through an identity block table.  q (B,H,D);
    context_lens (B,) -> (B,H,D).  On a CPU tensor the plain version runs
    (``paged_decode``'s dispatch); on a CUDA tensor the kernel, or its
    checks raise.  ``S`` must be a multiple of ``page_size`` (JAX asserts
    it; this raises ``ValueError``)."""
    B, S, Hkv, D = k.shape
    if S % page_size:
        raise ValueError(f"cache length {S} is not a multiple of the page "
                         f"size {page_size}")
    npages = S // page_size
    k_pool = k.reshape(B * npages, page_size, Hkv, D)
    v_pool = v.reshape(B * npages, page_size, Hkv, D)
    return paged_decode(q, k_pool, v_pool,
                        _identity_tables(B, npages, q.device),
                        context_lens.to(torch.int32))
