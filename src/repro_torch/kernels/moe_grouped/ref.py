"""Plain PyTorch version of the grouped expert kernels (``moe_grouped``).

It computes what the five kernels compute, step by step and with the same
rounding points, so that the CPU runs the dropless dispatch and the card's
tests hold the kernels against it:

1. route: the router's logits in the activations' dtype (the kernel rounds
   its float32 sum as a ``torch.matmul`` output is rounded), the padding
   experts at ``-1e30``, the top ``K`` logits in descending order (the
   lower expert first among equal logits), softmaxed in float32; an inert
   token (``valid`` false) routes to no expert: its ids are ``E``;
2. layout: the (token, k) rows ordered by expert, in (token, k) order
   within an expert (a stable counting sort);
3. the experts: ``h = silu(x @ wi_gate[e]) * (x @ wi_up[e])`` and ``h @
   wo[e]`` over each expert's rows, every product summed in float32 and
   rounded to the dtype;
4. combine: a token's K outputs, each times its routing weight (the weight
   rounded to the dtype first, as the dense dispatch rounds it), summed in
   k order; an inert token's output is zero.

Every product here is ``rowwise_mm``: a float32 sum over the inner
dimension written out, so that a row's bits do not depend on the other
rows of the call (a CPU GEMM's blocking, and with it its sum order,
depends on the number of rows).  The row accumulators (``stats``, one
layer's row of the engine's ``(L, 2E + 2)`` buffer) count each expert's
routed rows, the calls that reached it, and ``min(num_experts, routed
rows)`` a call (the last int64 is spare: it keeps the rows 16-byte
aligned).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rowwise_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, k) @ w (k, n) in float32, each row summed in one fixed order."""
    return (x.float()[:, :, None] * w.float()[None]).sum(1)


def route_reference(xt: torch.Tensor, router: torch.Tensor, top_k: int,
                    num_experts: int, valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt (T, d), router (d, E) -> (ids (T, K) int32, weights (T, K)
    float32); an inert token's ids are E."""
    E = router.shape[1]
    logits = rowwise_mm(xt, router).to(xt.dtype).float()
    logits[:, num_experts:] = NEG_INF
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    if valid is not None:
        topi = torch.where(valid[:, None], topi, torch.full_like(topi, E))
    return topi.to(torch.int32), torch.softmax(topv, dim=-1)


def layout_reference(ids: torch.Tensor, E: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids (T, K) -> (rows: the flat (token, k) indices of the routed rows
    ordered by expert, starts (E,), counts (E,))."""
    flat = ids.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=E + 1)[:E]
    starts = torch.cumsum(counts, 0) - counts
    return order[:int(counts.sum())], starts, counts  # repro: allow-graph-capture(the plain version: ops runs it for CPU tensors only, and a card runs the kernels)


def experts_reference(xt: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor, wi_gate: torch.Tensor,
                      wi_up: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The routed rows through their experts, then combined: xt (T, d),
    ids / weights (T, K), weights (E, d, f) / (E, f, d) -> (T, d)."""
    T, d = xt.shape
    K, E, dt = ids.shape[1], wi_gate.shape[0], xt.dtype
    rows, starts, counts = layout_reference(ids, E)
    out = xt.new_zeros((T * K, d))
    for e in torch.nonzero(counts).flatten().tolist():  # repro: allow-graph-capture(the plain version: ops runs it for CPU tensors only, and a card runs the kernels)
        r = rows[starts[e]:starts[e] + counts[e]]
        xe = xt[r // K]
        h = F.silu(rowwise_mm(xe, wi_gate[e]).to(dt)) \
            * rowwise_mm(xe, wi_up[e]).to(dt)
        out[r] = rowwise_mm(h, wo[e]).to(dt)
    out = out.view(T, K, d) * weights.to(dt)[..., None]
    y = out[:, 0]
    for k in range(1, K):
        y = y + out[:, k]
    return y


def count_rows(stats: torch.Tensor, ids: torch.Tensor,
               num_experts: int) -> None:
    """Add one call's routed rows to ``stats`` (2E + 2,) int64 in place."""
    E = (stats.shape[0] - 2) // 2
    counts = torch.bincount(ids.reshape(-1).long(), minlength=E + 1)[:E]
    stats[:E] += counts
    stats[E:2 * E] += (counts > 0).long()
    stats[2 * E] += min(num_experts, int(counts.sum()))  # repro: allow-graph-capture(the plain version: ops runs it for CPU tensors only, and a card runs the kernels)


def moe_grouped_reference(xt: torch.Tensor, router: torch.Tensor,
                          wi_gate: torch.Tensor, wi_up: torch.Tensor,
                          wo: torch.Tensor, *, top_k: int, num_experts: int,
                          valid: Optional[torch.Tensor] = None,
                          stats: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The dropless grouped MoE layer (no shared expert): xt (T, d) ->
    (T, d) (module docstring)."""
    ids, weights = route_reference(xt, router, top_k, num_experts, valid)
    if stats is not None:
        count_rows(stats, ids, num_experts)
    return experts_reference(xt, ids, weights, wi_gate, wi_up, wo)
