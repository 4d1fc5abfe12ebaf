"""Pooled-KV model steps for the engine's ``plane="paged"``.

Attention KV lives in per-layer page pools stacked over layers,
``(L, num_pages + sentinel pages, page_size, Hkv, D)``; a request's pages
are named by the ``PagedAllocator`` block table, passed in as a ``(B,
max_pages)`` int32 tensor.  The last ``sentinel_pages(nslots, page_size)``
pages of every pool are SENTINELS that no block table names: the decode
append aims the rows of inactive slots at them, which is how this port
gets the JAX version's out-of-range "drop" write without a boolean mask
(a host sync) and without clamped indices (which would make inactive rows
collide with live rows' slots).  Row b writes sentinel slot b, so no two
rows write one slot: a write whose winner is a race would leave bytes
that differ between a step graph's replay and an eager call.

* ``prefill``: the chunk's K/V are projected, then ONE fused kernel per
  layer — ``kernels.paged_attention.ops.paged_prefill`` — writes the
  chunk's real rows through the block table into the pools (padded rows
  write nothing) and attends causally over [own pages ++ the chunk].
* ``decode``: the new token's K/V row is written into its page (or the
  sentinel), then ``ops.paged_decode`` flash-decodes over the pages.

A Python loop over the stacked layer params replaces ``lax.scan``.  The
pools are updated IN PLACE (the JAX steps return new pools): the engine
holds one copy of them.  Sampling is fused: greedy argmax over the real
vocabulary on the device, and only ``(B,)`` int32 ids are returned.

``decode_and_advance`` is the engine's decode graph: one decode step over
a ``(3, B)`` cohort buffer, which it then advances in place to the next
step's inputs, so a steady cohort needs no upload between replays.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import scatter_rows
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.common import rms_norm

def sentinel_pages(nslots: int, page_size: int) -> int:
    """Pages every pool carries beyond the allocator's: the drop target,
    one slot per decode row."""
    return -(-nslots // page_size)


def paged_supported(cfg: ModelConfig) -> bool:
    """True iff the family's attention KV is unbounded dense (the only
    state worth paging)."""
    return (cfg.num_heads > 0 and not cfg.window
            and cfg.family not in ("ssm", "hybrid"))


def init_pools(cfg: ModelConfig, num_pages: int, page_size: int, *,
               nslots: int = 1, device: str = "cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V pools for ``num_pages`` allocator pages plus the
    sentinel pages of ``nslots`` decode rows: ``(L, num_pages +
    sentinel_pages(nslots, page), page, Hkv, D)``."""
    shape = (cfg.num_layers, num_pages + sentinel_pages(nslots, page_size),
             page_size,
             cfg.num_kv_heads, cfg.head_dim_)
    dtype = getattr(torch, cfg.dtype)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def prefill_layer(cfg: ModelConfig, lp: Any, x: torch.Tensor,
                  positions: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, block_tables: torch.Tensor,
                  starts: torch.Tensor, lengths: torch.Tensor,
                  moe_impl: str = "dense",
                  valid: Optional[torch.Tensor] = None,
                  stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of ``prefill_fn``: x (B, c, d) -> x after the layer; the
    chunk's K/V rows are written into the layer's pools by B2.  ``valid``
    (B, c) marks the chunk's real tokens and ``stats`` is the layer's MoE
    row accumulators, both for the grouped dispatch."""
    B, c = x.shape[:2]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(lp["attn"], cfg, h, positions)
    out = pa_ops.paged_prefill(
        q.contiguous(), k.contiguous(), v.contiguous(),
        k_pool, v_pool, block_tables, starts, lengths)
    x = x + out.reshape(B, c, cfg.q_dim) @ lp["attn"]["wo"]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + M._mlp_or_moe(cfg, lp, h, moe_impl, valid, stats)


def decode_layer(cfg: ModelConfig, lp: Any, x: torch.Tensor,
                 ctx: torch.Tensor, dest: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, block_tables: torch.Tensor,
                 ctx_lens: torch.Tensor, moe_impl: str = "dense",
                 valid: Optional[torch.Tensor] = None,
                 stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of ``decode_fn``: x (B, 1, d) -> x after the layer; the
    new token's K/V row is written at pool slot ``dest`` (B,), then B1
    attends over ``ctx_lens`` (B,) tokens of the row's pages.  ``valid``
    (B, 1) marks the active rows (``prefill_layer``)."""
    B = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(lp["attn"], cfg, h, ctx[:, None])
    scatter_rows(k_pool, dest, k[:, 0])
    scatter_rows(v_pool, dest, v[:, 0])
    out = pa_ops.paged_decode(q[:, 0].contiguous(), k_pool, v_pool,
                              block_tables, ctx_lens)
    x = x + (out.reshape(B, cfg.q_dim) @ lp["attn"]["wo"])[:, None]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + M._mlp_or_moe(cfg, lp, h, moe_impl, valid, stats)


def build_paged_fns(cfg: ModelConfig, moe_impl: str = "dense",
                    moe_stats: Optional[torch.Tensor] = None
                    ) -> Tuple[Callable, Callable]:
    """Returns ``(prefill_fn, decode_fn)`` over pooled KV; an MoE block's
    MLP is the ``moe_impl`` dispatch (``models.moe``).  Under the grouped
    dispatch the grid's padding and the inactive decode rows route to no
    expert, and layer l adds its routed rows to ``moe_stats[l]`` where
    given.

    prefill_fn(params, k_pools, v_pools, tokens (B, bucket),
               starts (B,), lengths (B,), block_tables (B, maxp))
        -> greedy ids (B,) int32
    decode_fn(params, k_pools, v_pools, tokens (B,), ctx (B,),
              block_tables (B, maxp), active (B,) bool)
        -> greedy ids (B,) int32

    Integer inputs are int32 on the pools' device; the pools are
    updated in place.
    """
    if not paged_supported(cfg):
        raise ValueError("paged pools need unbounded dense attention, "
                         f"got {cfg.family!r}")
    M.check_supported(cfg)
    vocab = cfg.vocab_size
    grouped = moe_impl == "grouped" and bool(cfg.num_experts)

    def _stats(l: int) -> Optional[torch.Tensor]:
        return None if moe_stats is None else moe_stats[l]

    def _finish(params: Any, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        logits = M._logits(cfg, params, x)
        return torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)

    def prefill_fn(params, k_pools, v_pools, tokens, starts, lengths,
                   block_tables):
        B, c = tokens.shape
        starts = starts.contiguous()
        lengths = lengths.contiguous()
        positions = starts[:, None] + torch.arange(c, device=tokens.device,
                                                   dtype=torch.int32)
        valid = (torch.arange(c, device=tokens.device)[None, :]
                 < lengths[:, None]) if grouped else None
        x, _ = M._embed(cfg, params, tokens.long(), positions)
        for l, lp in enumerate(M.unstack_layers(params)):
            x = prefill_layer(cfg, lp, x, positions, k_pools[l], v_pools[l],
                              block_tables, starts, lengths, moe_impl,
                              valid, _stats(l))
        last = torch.clamp(lengths.long() - 1, min=0)
        x_last = x[torch.arange(B, device=x.device), last]
        return _finish(params, x_last)

    def decode_fn(params, k_pools, v_pools, tokens, ctx, block_tables,
                  active):
        B = tokens.shape[0]
        P1, pg = k_pools.shape[1], k_pools.shape[2]
        maxp = block_tables.shape[1]
        ctx = ctx.long()
        page_idx = torch.gather(
            block_tables.long(), 1,
            torch.clamp(ctx // pg, 0, maxp - 1)[:, None])[:, 0]
        rows = torch.arange(B, device=tokens.device)
        dest = torch.where(active, page_idx * pg + ctx % pg,
                           (P1 - sentinel_pages(B, pg)) * pg + rows)
        # write-then-attend: context_lens = ctx + 1 includes the new token
        ctx_lens = (ctx + 1).to(torch.int32)
        x, _ = M._embed(cfg, params, tokens.long()[:, None], ctx[:, None])
        for l, lp in enumerate(M.unstack_layers(params)):
            x = decode_layer(cfg, lp, x, ctx, dest, k_pools[l], v_pools[l],
                             block_tables, ctx_lens, moe_impl,
                             active[:, None], _stats(l))
        return _finish(params, x[:, 0])

    return prefill_fn, decode_fn


def decode_and_advance(decode_fn: Callable, params: Any,
                       k_pools: torch.Tensor, v_pools: torch.Tensor,
                       cohort: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """One ``decode_fn`` step over ``cohort`` (3, B) int32, rows [tokens,
    ctx, active], then the next step's inputs written into the same
    buffer: tokens <- the sampled ids, ctx += active.  Returns the ids
    (the tokens row, a view of ``cohort``)."""
    toks, ctx, active = cohort.unbind(0)
    ids = decode_fn(params, k_pools, v_pools, toks, ctx, block_tables,
                    active.bool())
    toks.copy_(ids)
    ctx.add_(active)
    return toks
