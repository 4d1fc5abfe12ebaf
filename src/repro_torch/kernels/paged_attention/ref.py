"""Plain PyTorch versions of the paged-attention kernels.

Each mirrors ``repro.kernels.paged_attention.ref`` operation for
operation — the block-table gather, fp32 scores, the ``-1e30`` mask,
``softmax``, and the cast of the weights to the value dtype before the
PV product — so the CPU port reproduces the JAX engine token for token.
They are the CPU lowering of ``ops`` and the oracle the CUDA kernels are
held against on the card; nothing on the main path calls them when the
tensors live on a GPU.

Unlike the JAX oracles, which return new pools, the prefill here
updates the pools IN PLACE, like the kernel it stands for.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_decode_reference(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor) -> torch.Tensor:
    """q (B,H,D); pools (P, page, Hkv, D); block_tables (B, npages);
    context_lens (B,) -> out (B,H,D)."""
    B, H, D = q.shape
    page, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = H // Hkv
    npages = block_tables.shape[1]
    S = npages * page
    bt = block_tables.long()
    k = k_pool[bt].reshape(B, S, Hkv, D)                # gather pages
    v = v_pool[bt].reshape(B, S, Hkv, D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    s = s / math.sqrt(D)
    valid = (torch.arange(S, device=q.device)[None]
             < context_lens.long()[:, None])             # (B, S)
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w.to(v.dtype), v)
    return out.reshape(B, H, D)


def paged_decode_split_model(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_tables: torch.Tensor,
                             context_lens: torch.Tensor,
                             span: int) -> torch.Tensor:
    """The CUDA decode kernel's split-and-merge, in plain PyTorch (tests
    only; ``paged_decode_reference`` stays the oracle).

    Row b attends over positions [0, min(ctx[b], npages * page)).  Split
    s owns positions [s * span, (s + 1) * span) and computes its fp32
    partial (m, l, acc): its max score (-inf when it has no visible key),
    sum of exp(score - m) and the weighted sum of values.  The merge
    rescales every partial by exp(m_s - max m) (0 for an empty split) and
    divides by the merged l clamped to 1e-30, so a row with no visible key
    gives zeros.  q (B,H,D); pools (P, page, Hkv, D) -> (B,H,D), q's
    dtype."""
    B, H, D = q.shape
    page, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = H // Hkv
    npages = block_tables.shape[1]
    S = npages * page
    nsplit = -(-S // span)
    bt = block_tables.long().clamp(0, k_pool.shape[0] - 1)
    k = k_pool[bt].reshape(B, S, Hkv, D).float()
    v = v_pool[bt].reshape(B, S, Hkv, D).float()
    pad = nsplit * span - S
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nkeys = context_lens.long().clamp(0, S)
    visible = (torch.arange(nsplit * span, device=q.device)[None]
               < nkeys[:, None])                                # (B, S')
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, G, D).float(), k)
    s = (s / math.sqrt(D)).masked_fill(~visible[:, None, None], -math.inf)
    s = s.reshape(B, Hkv, G, nsplit, span)
    m = s.amax(-1)                                              # (B,Hkv,G,n)
    empty = torch.isinf(m)
    p = torch.exp(s - torch.where(empty, 0.0, m)[..., None])
    l_s = p.sum(-1)
    acc = torch.einsum("bhgnk,bnkhd->bhgnd", p,
                       v.reshape(B, nsplit, span, Hkv, D))
    M = m.amax(-1, keepdim=True)
    w = torch.where(empty, 0.0, torch.exp(m - torch.where(torch.isinf(M),
                                                          0.0, M)))
    out = (w[..., None] * acc).sum(-2) \
        / (w * l_s).sum(-1).clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def scatter_rows(pool: torch.Tensor, dest: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """Write rows (..., Hkv, D) into a (P, page, Hkv, D) pool at flat
    token positions ``dest`` (...,), in place.  Every ``dest`` must lie
    inside the pool: where the JAX version drops out-of-range rows, the
    caller aims rows to be dropped at a sentinel page that no block table
    names (``serving.paged_plane``), so the write needs neither a mask
    nor a host sync."""
    P, pg, Hkv, D = pool.shape
    pool.view(P * pg, Hkv, D).index_copy_(0, dest.reshape(-1).long(),
                                          rows.reshape(-1, Hkv, D))


def paged_prefill_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            starts: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Gather-write-attend chunked prefill.

    q (B, c, H, D); k/v (B, c, Hkv, D) — the chunk's projected rows;
    pools (P, page, Hkv, D); block_tables (B, maxp); starts/lengths
    (B,).  Returns the attention output (B, c, H, D) and writes chunk row
    ``r < lengths[b]`` into the pools at position ``starts[b] + r``
    through the block table; padded rows write nothing.  Table slot j
    covers positions [j*page, (j+1)*page), so the gathered view is in
    position order and each query attends causally over it.
    """
    B, c, H, D = q.shape
    P, pg, Hkv, _ = k_pool.shape
    maxp = block_tables.shape[1]
    Smax = maxp * pg
    G = H // Hkv
    dev = q.device
    bt = block_tables.long()
    ar = torch.arange(c, device=dev)
    positions = starts.long()[:, None] + ar[None, :]            # (B, c)
    valid = ar[None, :] < lengths.long()[:, None]               # (B, c)

    kg = k_pool[bt].reshape(B, Smax, Hkv, D)
    vg = v_pool[bt].reshape(B, Smax, Hkv, D)
    rows = torch.arange(B, device=dev)[:, None].expand(B, c)
    sel = valid & (positions < Smax)
    kg[rows[sel], positions[sel]] = k[sel]
    vg[rows[sel], positions[sel]] = v[sel]

    mask = (torch.arange(Smax, device=dev)[None, None, :]
            <= positions[:, :, None])
    qg = q.reshape(B, c, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), kg.float())
    s = s / math.sqrt(D)
    s = s.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(vg.dtype), vg)
    out = out.reshape(B, c, H, D)

    page_idx = torch.gather(bt, 1, torch.clamp(positions // pg, 0, maxp - 1))
    dest = (page_idx * pg + positions % pg)[valid]
    k_pool.view(P * pg, Hkv, D)[dest] = k[valid]
    v_pool.view(P * pg, Hkv, D)[dest] = v[valid]
    return out
