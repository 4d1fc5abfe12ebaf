"""Device-dispatched grouped MoE layer: the dropless dispatch's entry point.

``moe_grouped`` runs the hand-written Triton kernels
(``moe_grouped.moe_grouped_cuda``) on CUDA tensors and the plain PyTorch
version (``ref.moe_grouped_reference``) on CPU tensors -- only because the
tensors lie on the CPU.  On any other device the kernel wrapper's checks
raise; nothing falls back.

It is forward-only: the layer serves, and training takes the dense or the
capacity dispatch (``models.moe``).  A backward through it raises
``NoBackwardError``.

``row_counters`` reads the serving engine's row accumulators
(``Engine.moe_stats``) once, when a run ends.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.kernels import NoBackwardError
from repro_torch.kernels.moe_grouped.moe_grouped import moe_grouped_cuda
from repro_torch.kernels.moe_grouped.ref import moe_grouped_reference


class _ForwardOnly(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xt, router, wi_gate, wi_up, wo, top_k, num_experts,
                valid, stats):
        kw = dict(top_k=top_k, num_experts=num_experts, valid=valid,
                  stats=stats)
        if xt.device.type == "cpu":
            return moe_grouped_reference(xt, router, wi_gate, wi_up, wo,
                                         **kw)
        return moe_grouped_cuda(xt, router, wi_gate, wi_up, wo, **kw)

    @staticmethod
    def backward(ctx, grad_out):
        raise NoBackwardError(
            "moe_grouped is forward-only: train with moe_impl 'dense' or "
            "'sparse'")


def moe_grouped(xt: torch.Tensor, router: torch.Tensor,
                wi_gate: torch.Tensor, wi_up: torch.Tensor, wo: torch.Tensor,
                *, top_k: int, num_experts: int,
                valid: Optional[torch.Tensor] = None,
                stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xt (T, d); router (d, E); wi_gate / wi_up (E, d, f); wo (E, f, d);
    valid (T,) bool (None: every token live); stats (2E + 2,) int64 row
    accumulators, added to in place (None: none) -> (T, d): the routed
    experts' outputs, combined (no shared expert)."""
    return _ForwardOnly.apply(xt, router, wi_gate, wi_up, wo, int(top_k),
                              int(num_experts), valid, stats)


def row_counters(stats: Optional[torch.Tensor],
                 num_experts: int) -> Dict[str, object]:
    """The row accumulators ``stats`` (L, 2E + 2) of a run, read from the
    device (one sync: call it once, when the run ends): routed rows over
    every layer, the experts reached per call as a share (%) of
    ``min(experts, routed rows)`` (what a roofline that reads each routed
    expert once assumes), the busiest (layer, expert)'s rows over the
    mean, and the reached share by layer; {} for None."""
    if stats is None:
        return {}
    E = (stats.shape[1] - 2) // 2
    s = stats.cpu().double()
    n = num_experts
    rows, hits, need = s[:, :n], s[:, E:E + n], s[:, 2 * E]
    mean = float(rows.mean())
    by_layer: List[float] = (100.0 * hits.sum(1)
                             / need.clamp(min=1.0)).tolist()
    return {"moe_routed_rows": float(rows.sum()),
            "moe_experts_reached_share":
                100.0 * float(hits.sum()) / max(float(need.sum()), 1.0),
            "moe_expert_load_max_over_mean":
                float(rows.max()) / mean if mean else 0.0,
            "reached_share_by_layer": by_layer}
