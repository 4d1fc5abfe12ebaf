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
* ``apply_moe_ep``: the expert-parallel dispatch over the ambient mesh
  (``distributed.context.set_mesh``).  Experts are sharded over the
  ``model`` axis; each rank routes its tokens (the router replicated),
  packs capacity buffers per destination rank, exchanges them with one
  all-to-all, runs its local experts on per-expert capacity buffers and
  returns the rows with a second all-to-all.  JAX's arithmetic: ``dest =
  topi // e_loc``, capacities ``max(1, int(factor * T * K / n))`` and
  ``cap2 = max(1, int(factor * R / e_loc))`` as Python ints, dropped
  entries adding nothing, the expert products in fp32 with JAX's casts;
  buffers are written by indexed copies as in ``apply_moe_sparse``.
  Where the tokens are replicated over the expert axis (a decode step),
  every rank takes the first rank's expert results, so that the ranks
  agree where a duplicate row overflows a capacity (JAX's controller
  reads the first device's replica).
* ``apply_moe_grouped``: the dropless grouped dispatch, which has no JAX
  counterpart (``kernels.moe_grouped``: hand-written Triton kernels on a
  card, their plain version on the CPU).  Each token's K routed rows are
  laid out by expert on the device and run through grouped products over
  each expert's rows, reading the stacked weights in place; a token's K
  outputs are summed in k order, with no atomics.  Tokens marked inert
  (``valid`` false: the padding of a prefill grid, a decode row with no
  request) route to no expert and cost no expert work.  Row-independent
  bit for bit and free of host syncs, so the engine packs its prefill
  grid and captures it in step graphs; ``stats``, where given, counts the
  routed rows per expert on the device.

Every product of the other dispatches is a plain ``torch.matmul``: the JAX
package computes the MoE layer outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (P, all_to_all, axis_size,
                                             dp_axes_of, get_mesh, reshape,
                                             shard_map_compat, spmd,
                                             to_dtensor)
from repro_torch.kernels.moe_grouped import ops as grouped_ops
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


def _shared_expert(params: Params, xt: torch.Tensor) -> torch.Tensor:
    """The sigmoid-gated shared expert (gate in fp32, then cast)."""
    sg = torch.sigmoid((xt @ params["shared_gate"]).float())
    return sg.to(xt.dtype) * gated_mlp(params["shared"], xt)


def _shared(params: Params, cfg: ModelConfig, xt: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Add the shared expert where the config has one."""
    if not cfg.num_shared_experts:
        return y
    return y + _shared_expert(params, xt)


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


def _pack(rows: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
          n: int) -> torch.Tensor:
    """An (n, ...) zero buffer with kept entry i of ``rows`` at row
    ``slot[i]`` (kept slots are distinct; dropped entries land on a
    scratch row that is cut off): JAX's ``zeros.at[slot].add(where(keep,
    rows, 0))``."""
    dest = torch.where(keep, slot, torch.full_like(slot, n))
    buf = rows.new_zeros((n + 1,) + rows.shape[1:])
    buf[dest] = rows
    return buf[:n]


@spmd
def apply_moe_ep(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 capacity_factor: float = 1.25,
                 ep_axis: str = "model") -> torch.Tensor:
    """Expert-parallel MoE: x (B, S, d) -> (B, S, d) (module docstring).
    Tokens overflowing a (src, dst) pair's capacity or a local expert's
    are dropped (GShard semantics); equal to ``apply_moe`` when nothing
    overflows.  The sequence is sharded over the expert axis when it
    divides (else every rank routes the same replicated tokens); the
    shared experts run outside the sharded region."""
    mesh = get_mesh()
    if mesh is None:
        raise ValueError("apply_moe_ep requires distributed.context"
                         ".set_mesh(mesh)")
    dp = dp_axes_of(mesh)
    n = axis_size(mesh, ep_axis)
    B, S, d = x.shape
    E, K = cfg.padded_experts, cfg.experts_per_token
    e_loc = E // n

    def local(xb, router, wg, wu, wo):
        T = xb.shape[0] * xb.shape[1]
        xt = xb.reshape(T, d)
        # the router is replicated: tokens are row-sharded over the ep
        # axis, so each rank needs every expert's logit for its tokens
        weights, topi = route({"router": router}, cfg, xt)
        dest = topi // e_loc                                 # target rank
        local_eid = topi % e_loc
        # ---- pack per destination rank ------------------------------- #
        cap = max(1, int(capacity_factor * T * K / n))
        slot, keep = dispatch_slots(dest, n, cap)
        send_x = _pack(xt.repeat_interleave(K, dim=0), slot, keep, n * cap)
        send_e = _pack(local_eid.reshape(-1) + 1, slot, keep, n * cap)
        recv_x = all_to_all(send_x, ep_axis, mesh)
        recv_e = all_to_all(send_e, ep_axis, mesh)
        # ---- local experts on capacity buffers ----------------------- #
        R = n * cap
        valid = recv_e > 0
        eid = torch.clamp(recv_e - 1, min=0)
        oh2 = ((eid[:, None] == torch.arange(e_loc, device=eid.device))
               & valid[:, None]).long()
        pos2 = ((torch.cumsum(oh2, dim=0) - 1) * oh2).sum(-1)
        cap2 = max(1, int(capacity_factor * R / e_loc))
        keep2 = (pos2 < cap2) & valid
        slot2 = eid * cap2 + torch.where(keep2, pos2, torch.zeros_like(pos2))
        buf = _pack(recv_x, slot2, keep2, e_loc * cap2).view(e_loc, cap2, d)
        h = F.silu(torch.matmul(buf.float(), wg.float()))
        h = (h * torch.matmul(buf.float(), wu.float())).to(xt.dtype)
        out = torch.matmul(h.float(), wo.float()).reshape(
            e_loc * cap2, d).to(xt.dtype)
        y_rows = out[slot2] * keep2[:, None].to(out.dtype)
        if seq is None:
            # the tokens are replicated over the axis, so every source
            # sent the same rows, and a later source's copy can overflow
            # an expert where the first's did not: every source takes the
            # first's results, so the ranks agree (JAX's controller reads
            # the first device's replica of a replicated output)
            y_rows = y_rows.view(n, cap, d)[:1].expand(n, cap, d).reshape(
                n * cap, d)
        # ---- return + combine at the source ---------------------------- #
        ret = all_to_all(y_rows, ep_axis, mesh)
        y_tk = ret[slot] * keep[:, None].to(ret.dtype)
        y_tk = y_tk * weights.reshape(-1)[:, None].to(ret.dtype)
        return _sum_in_k_order(y_tk.view(T, K, d)).reshape(xb.shape)

    seq = ep_axis if S % n == 0 else None
    y = shard_map_compat(
        local, mesh=mesh,
        in_specs=(P(dp, seq, None), P(None, None), P(ep_axis, None, None),
                  P(ep_axis, None, None), P(ep_axis, None, None)),
        out_specs=P(dp, seq, None),
    )(x, params["router"], params["wi_gate"], params["wi_up"], params["wo"])
    if cfg.num_shared_experts:
        shared = reshape(_shared_expert(params, reshape(x, B * S, d)),
                         B, S, d)
        y = y + to_dtensor(shared, mesh, P(dp, seq, None))
    return y


def apply_moe_grouped(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      valid: Optional[torch.Tensor] = None,
                      stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dropless grouped dispatch; x (B, S, d) -> (B, S, d).  ``valid``
    (B, S) bool marks the live tokens (None: all); ``stats`` is the
    layer's ``(2E + 2,)`` int64 row accumulators (``Engine.moe_stats``),
    or None.  The same routing as ``route`` (the lower expert first among
    equal logits); an inert token's routed part is zero."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    y = grouped_ops.moe_grouped(
        xt, params["router"], params["wi_gate"], params["wi_up"],
        params["wo"], top_k=cfg.experts_per_token,
        num_experts=cfg.num_experts,
        valid=None if valid is None else valid.reshape(B * S),
        stats=stats)
    return _shared(params, cfg, xt, y).reshape(B, S, d)


#: moe_impl -> dispatch, as ``repro.models.model._mlp_or_moe`` picks it
#: (``"grouped"`` is the port's own)
DISPATCH = {"dense": apply_moe, "sparse": apply_moe_sparse,
            "ep": apply_moe_ep, "grouped": apply_moe_grouped}

