"""Mixture-of-experts layer: ``repro.models.moe`` for the port.

Expert weights are stacked ``(E, d_model, moe_ff)`` (and ``(L, E, ...)``
across layers), with ``repro``'s tree keys (``router``, ``wi_gate``,
``wi_up``, ``wo``, ``shared``, ``shared_gate``), so
``models.model.params_from_jax`` carries them unchanged.  Routing is
top-k with softmax-after-topk (Qwen style); padding experts (qwen2-moe
60 -> 64) get router logits of -1e30 and so exactly zero weight.

* ``apply_moe``: the dense dispatch.  Every expert sees every token; the
  expert products are broadcast batched matmuls ``(T, d) @ (E, d, f) ->
  (E, T, f)`` that read the stacked weights in place (an einsum may copy
  them into a permuted layout first: 1.1 GB per layer at qwen2-moe).
  Each token then sums its K selected experts' outputs, weighted, in k
  order.  The other experts' combine weights are exact zeros in JAX's
  ``(T, E)`` combine, so this is the same sum without the zero terms.
  Row-independent, hence chunk-invariant: the engine's default.
* ``apply_moe_sparse``: capacity buffers of ``C = max(1, int(factor * T
  * K / E))`` rows per expert, tokens past an expert's capacity dropped
  (GShard semantics) exactly as JAX drops them.  No scatter-add: each
  kept (token, k) owns a unique buffer row and is written with a plain
  indexed copy (dropped ones go to a scratch row), and the K
  contributions of a token are summed in k order, so a call is
  bit-reproducible on a card (atomics would not be, and a step graph's
  replay must equal its eager call).
* ``apply_moe_ep`` (the expert-parallel dispatch over a device mesh) is
  ROADMAP A13 and raises.

Every product is a plain ``torch.matmul``: the JAX package computes the
MoE layer outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (Params, dense_init, gated_mlp,
                                       gated_mlp_init)

NEG_INF = -1e30


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    """``repro``'s init scales: router N(0, 1/d), expert input weights
    N(0, 1/d), expert output weights N(0, 1/moe_d_ff), the shared expert a
    gated MLP of width ``num_shared_experts * moe_d_ff`` and its gate
    N(0, 1/d); each of shape ``lead + ...``."""
    E, d, f = cfg.padded_experts, cfg.d_model, cfg.moe_d_ff

    def normal(shape, scale):
        w = torch.randn(lead + shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    p: Params = {"router": dense_init(gen, d, E, dtype, lead),
                 "wi_gate": normal((E, d, f), d ** -0.5),
                 "wi_up": normal((E, d, f), d ** -0.5),
                 "wo": normal((E, f, d), f ** -0.5)}
    if cfg.num_shared_experts:
        p["shared"] = gated_mlp_init(gen, d, cfg.num_shared_experts * f,
                                     dtype, lead)
        p["shared_gate"] = dense_init(gen, d, 1, dtype, lead)
    return p


def route(params: Params, cfg: ModelConfig, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt (T, d) -> (weights (T, K) fp32, experts (T, K) int64): the top
    K router logits in descending order (``lax.top_k``'s), softmaxed."""
    logits = (xt @ params["router"]).float()              # (T, E)
    if cfg.padded_experts > cfg.num_experts:
        logits[:, cfg.num_experts:] = NEG_INF
    topv, topi = torch.topk(logits, cfg.experts_per_token, dim=-1)
    return torch.softmax(topv, dim=-1), topi


def _shared(params: Params, cfg: ModelConfig, xt: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Add the sigmoid-gated shared expert (gate in fp32, then cast)."""
    if not cfg.num_shared_experts:
        return y
    sg = torch.sigmoid((xt @ params["shared_gate"]).float())
    return y + sg.to(xt.dtype) * gated_mlp(params["shared"], xt)


def _experts(params: Params, buf: torch.Tensor) -> torch.Tensor:
    """The expert MLPs over per-expert rows: buf (E, R, d) or (R, d)
    broadcast to every expert -> (E, R, d).  Batched products against
    the stacked weights as they lie."""
    h = F.silu(torch.matmul(buf, params["wi_gate"])) \
        * torch.matmul(buf, params["wi_up"])
    return torch.matmul(h, params["wo"])


def _sum_in_k_order(y_tk: torch.Tensor) -> torch.Tensor:
    """(T, K, d) -> (T, d): ((y_0 + y_1) + y_2) + ..., JAX's scatter-add
    order over a token's K entries."""
    y = y_tk[:, 0]
    for k in range(1, y_tk.shape[1]):
        y = y + y_tk[:, k]
    return y


def apply_moe(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """The dense dispatch; x (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    weights, topi = route(params, cfg, xt)
    out = _experts(params, xt)                              # (E, T, d)
    rows = torch.arange(B * S, device=x.device)[:, None]
    sel = out[topi, rows]                                   # (T, K, d)
    y = _sum_in_k_order(sel * weights[..., None].to(out.dtype))
    return _shared(params, cfg, xt, y).reshape(B, S, d)


def capacity(cfg: ModelConfig, T: int, capacity_factor: float) -> int:
    """Rows per expert buffer: a function of the shapes alone."""
    E, K = cfg.padded_experts, cfg.experts_per_token
    return max(1, int(capacity_factor * T * K / E))


def dispatch_slots(topi: torch.Tensor, E: int, C: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """topi (T, K) -> (buffer row (T*K,), kept (T*K,) bool): entry i goes
    to row ``e * C + pos`` where ``pos`` counts the earlier entries (in
    (token, k) order) routed to the same expert e; it is kept iff
    ``pos < C``.  A dropped entry's row is its expert's first."""
    flat_e = topi.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(E, device=topi.device)
              ).long()                                      # (T*K, E)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    keep = pos < C
    return flat_e * C + torch.where(keep, pos, torch.zeros_like(pos)), keep


def apply_moe_sparse(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     capacity_factor: float = 1.25) -> torch.Tensor:
    """Capacity-based sparse dispatch; x (B, S, d) -> (B, S, d).  Equal
    to ``apply_moe`` whenever no expert overflows its capacity."""
    B, S, d = x.shape
    E, K = cfg.padded_experts, cfg.experts_per_token
    T = B * S
    C = capacity(cfg, T, capacity_factor)
    xt = x.reshape(T, d)
    weights, topi = route(params, cfg, xt)
    buf_idx, keep = dispatch_slots(topi, E, C)
    # kept entries own unique rows; dropped ones land on the scratch row
    dest = torch.where(keep, buf_idx, torch.full_like(buf_idx, E * C))
    buffers = xt.new_zeros((E * C + 1, d))
    buffers[dest] = xt.repeat_interleave(K, dim=0)
    out = _experts(params, buffers[:E * C].view(E, C, d)).reshape(E * C, d)
    y_tk = out[buf_idx] * keep[:, None].to(out.dtype)
    y_tk = y_tk * weights.reshape(-1)[:, None].to(out.dtype)
    y = _sum_in_k_order(y_tk.view(T, K, d))
    return _shared(params, cfg, xt, y).reshape(B, S, d)


def apply_moe_ep(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 capacity_factor: float = 1.25,
                 ep_axis: str = "model") -> torch.Tensor:
    """The expert-parallel dispatch (all-to-all over a mesh axis)."""
    raise ValueError("moe_impl 'ep' (expert parallelism over a device "
                     "mesh) is not ported yet (ROADMAP A13)")


#: moe_impl -> dispatch, as ``repro.models.model._mlp_or_moe`` picks it
DISPATCH = {"dense": apply_moe, "sparse": apply_moe_sparse,
            "ep": apply_moe_ep}

