"""GQA attention with a dense KV cache: ``repro.models.attention``.

* full-sequence (train / prefill): causal (+ optional sliding window
  ``cfg.window``, + optional prefix-LM) attention over the whole batch,
  optionally emitting a cache padded to ``cache_len`` (or, under a
  window, cropped to the last ``cache_len`` K/V in ring order).
  ``impl="flash"`` runs the hand-written flash-attention kernel
  (``kernels.flash_attention``, forward-only, with the window); every
  other ``impl`` the plain reference branch, as in the JAX package.
* chunked prefill (``attention_chunk``): the next c tokens of each row
  against an existing cache, with a ``length`` mask for the engine's
  bucketed rounds (the slot-resident planes' chunk step).  Under a
  window the cache is a ring of exactly ``window`` slots (slot = position
  mod window), and the chunk attends to the old ring before it writes.
* decode: one query token against a dense cache ``(B, S, Hkv, D)`` with
  a per-request length mask; under a window the new token goes to ring
  slot ``index mod S``.  ``impl`` picks the backend as in JAX:
  ``"paged"`` views the contiguous cache as 64-token pages and runs the
  hand-written paged decode kernel (``kernels.paged_attention.ops.
  decode_attention_dense``, B1), ``"flash_jnp"`` the chunked online-
  softmax loop (``_sdpa_flash_decode``), ``"seqsharded"`` flash-decodes
  a cache whose sequence is sharded over the ambient mesh's ``model``
  axis (``distributed.collectives``; the new row is written by the rank
  that owns its slot), anything else the reference branch.
  ``attention_decode_deferred`` reads a read-only cache and returns the
  new token's K/V for the caller's one scatter per step.

These are the token oracle (``serving.engine.generate_reference``), the
trainer's attention, the slot-resident planes' attention and the
model-level parity surface.  The engine's pooled plane runs the paged
kernels through ``serving.paged_plane`` instead.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    decode_attn_partials, make_seqsharded_decode_attn,
    make_seqsharded_decode_attn_partials, seqsharded_write)
from repro_torch.distributed.context import get_mesh, plain_like, reshape
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.common import (Params, apply_rope, causal_mask,
                                       dense_init, rms_norm)

NEG_INF = -1e30

def merge_softmax_groups(out1: torch.Tensor, m1: torch.Tensor,
                         l1: torch.Tensor, s2: torch.Tensor,
                         v2: torch.Tensor) -> torch.Tensor:
    """Numerically-stable merge of a softmax group (out1 with running
    max m1 / sum l1) with one extra logit s2 / value v2.
    out1 (B,H,D); m1,l1 (B,H); s2 (B,H); v2 (B,H,D)."""
    M = torch.maximum(m1, s2)
    w1 = l1 * torch.exp(m1 - M)
    w2 = torch.exp(s2 - M)
    denom = torch.clamp(w1 + w2, min=1e-30)
    return (out1 * w1[..., None] + v2 * w2[..., None]) / denom[..., None]


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> Params:
    p = {"wq": dense_init(gen, cfg.d_model, cfg.q_dim, dtype, lead),
         "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, lead),
         "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, lead),
         "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dtype, lead)}
    if cfg.qk_norm:
        for k in ("q_norm", "k_norm"):
            p[k] = torch.zeros(lead + (cfg.head_dim_,), dtype=dtype,
                               device=gen.device)
    return p


def _project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = reshape(x @ params["wq"], B, S, H, D)
    k = reshape(x @ params["wk"], B, S, Hkv, D)
    v = reshape(x @ params["wv"], B, S, Hkv, D)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D), GQA via head grouping; scores and
    softmax in fp32 (bf16 products are exact in fp32, so upcasting before
    the product is JAX's ``preferred_element_type=float32``)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = reshape(q, B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return reshape(out, B, Sq, H, D)


def attention_full(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, *, prefix_len: int = 0,
                   impl: str = "reference", cache_len: int = 0
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Train / prefill attention.  Returns (out, cache_or_None);
    ``cache_len`` >= S also emits a KV cache zero-padded to that length.
    Under a sliding window a shorter ``cache_len`` keeps the last
    ``cache_len`` K/V in ring order (row = position mod cache_len), so
    decode's ring writes stay aligned; full attention refuses to crop.
    ``impl="flash"`` assumes ``positions`` are ``0..S-1`` on every row,
    as the JAX kernel does."""
    B, S, _ = x.shape
    if cache_len and cache_len < S and not cfg.window:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}: only "
                         "the sliding-window ring crops")
    q, k, v = _project_qkv(params, cfg, x, positions)
    if impl == "flash":
        out = fa_ops.flash_attention(q, k, v, window=cfg.window,
                                     prefix_len=prefix_len)
    else:
        out = _sdpa(q, k, v, causal_mask(positions, positions,
                                         window=cfg.window,
                                         prefix_len=prefix_len))
    out = reshape(out, B, S, cfg.q_dim) @ params["wo"]
    cache = None
    if cache_len >= S:
        pad = (0, 0, 0, 0, 0, cache_len - S)
        cache = {"k": torch.nn.functional.pad(k, pad),
                 "v": torch.nn.functional.pad(v, pad)}
    elif cache_len:
        s0 = (S - cache_len) % cache_len
        cache = {"k": torch.roll(k[:, -cache_len:], s0, dims=1),
                 "v": torch.roll(v[:, -cache_len:], s0, dims=1)}
    return out, cache


def _sdpa_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, *, chunk: int = 1024
                       ) -> torch.Tensor:
    """One-token decode attention without materializing (B, H, S) scores:
    a loop over KV chunks carrying fp32 (m, l, acc), JAX's ``lax.scan``
    form with its chunk rule (``Q = min(chunk, S)``, halved until it
    divides S).  q (B,H,D); k/v (B,S,Hkv,D); lengths (B,) valid KVs."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    qg = q.reshape(B, Hkv, G, D).float() / math.sqrt(D)
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    ar = torch.arange(Q, device=q.device)
    for i in range(S // Q):
        kq, vq = k[:, i * Q:(i + 1) * Q], v[:, i * Q:(i + 1) * Q]
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kq.float())
        visible = (i * Q + ar)[None, :] < lengths[:, None]      # (B, Q)
        s = torch.where(visible[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = (alpha[..., None] * acc
               + torch.einsum("bhgk,bkhd->bhgd", p, vq.float()))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def attention_chunk(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    cache: Dict, start: torch.Tensor, *,
                    impl: str = "reference",
                    length: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """Chunked prefill against an existing cache (the slot planes' path).

    x: (B, c, d), the next c prompt tokens of each row, whose first
    absolute position is ``start[b]``; cache[k|v]: (B, Smax, Hkv, D)
    holds the first ``start[b]`` KVs.  Returns (out, new cache); the
    inputs are not modified.  ``impl`` is accepted for the JAX signature
    (its chunk step has no kernel either).

    ``length`` (B,) marks only the first ``length[b]`` tokens of row b as
    real: the rest are shape padding, and the cache after the call is
    bit-equal to an unpadded call of ``length[b]`` tokens (rows with
    length 0 are untouched).  JAX routes padded K/V to an out-of-bounds
    slot and drops them; torch has no drop mode, and a boolean compaction
    would ask the host for a count.  So token j of row b writes at
    ``(start[b] + j) mod Smax``, which are c distinct slots per row when
    ``c <= Smax``, and a padded token writes back the bytes it finds
    there: one deterministic scatter of fixed shape, safe under a CUDA
    graph.  A real token past the cache is the caller's error (the engine
    refuses such requests at ``submit``; JAX would clamp it to slot
    ``Smax - 1``).  Padded queries give rows the caller must ignore;
    padded keys never reach a real query (the causal mask hides them).

    Under a sliding window the cache is a ring of exactly ``window``
    slots and ``c <= window`` (so a chunk's slots are distinct), and the
    chunk attends BEFORE it writes: its tokens would overwrite ring slots
    still visible to its earlier queries.  The keys are the old ring,
    each slot's position rebuilt from the row's newest old position
    ``start - 1`` (``-1`` on a fresh row, hence a floored modulo), then
    the chunk itself, under the causal window mask; then the chunk is
    written as above.
    """
    B, c, _ = x.shape
    Smax = cache["k"].shape[1]
    if c > Smax:
        raise ValueError(f"chunk of {c} tokens > cache length {Smax}")
    if cfg.window and cfg.window != Smax:
        raise ValueError(f"window {cfg.window}: the ring cache must be "
                         f"exactly window-sized, not {Smax}")
    ar = torch.arange(c, device=x.device)
    positions = start.long()[:, None] + ar[None, :]            # (B, c)
    q, k, v = _project_qkv(params, cfg, x, positions)
    qpos = positions[:, :, None]                               # (B, c, 1)
    sidx = torch.arange(Smax, device=x.device)[None, None, :]
    if cfg.window:
        prev_newest = positions[:, :1, None] - 1               # (B, 1, 1)
        key_pos_old = prev_newest - torch.remainder(prev_newest - sidx,
                                                    Smax)
        mask_old = ((key_pos_old >= 0) & (key_pos_old <= qpos)
                    & (qpos - key_pos_old < cfg.window))       # (B, c, Smax)
        kpos_new = positions[:, None, :]                       # (B, 1, c)
        mask_new = (kpos_new <= qpos) & (qpos - kpos_new < cfg.window)
        out = _sdpa(q, torch.cat([cache["k"], k], dim=1),
                    torch.cat([cache["v"], v], dim=1),
                    torch.cat([mask_old, mask_new], dim=2))
    dest = (positions % Smax)[:, :, None, None].expand_as(k)
    if length is not None:
        valid = (ar[None, :] < length[:, None])[:, :, None, None]
        k = torch.where(valid, k, cache["k"].gather(1, dest))
        v = torch.where(valid, v, cache["v"].gather(1, dest))
    new_k = cache["k"].clone().scatter_(1, dest, k)
    new_v = cache["v"].clone().scatter_(1, dest, v)
    if not cfg.window:
        out = _sdpa(q, new_k, new_v, sidx <= qpos)             # causal
    out = out.reshape(B, c, cfg.q_dim) @ params["wo"]
    return out, {"k": new_k, "v": new_v}


def attention_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict, cache_index: torch.Tensor, *,
                     impl: str = "reference") -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); cache[k|v]: (B, Smax, Hkv, D);
    cache_index: (B,) number of valid cache entries (also the position).
    The new token is written (under a window, at ring slot ``index mod
    Smax``), then attended (``min(index + 1, Smax)`` keys; attention is
    order-free, so the ring needs no reordering), by the backend ``impl``
    picks (module docstring).  Returns new cache tensors; the inputs are
    not modified."""
    B = x.shape[0]
    Smax = cache["k"].shape[1]
    if cfg.window and cfg.window < Smax:
        raise ValueError(f"window {cfg.window}: a ring cache of {Smax} "
                         "slots is longer than the window")
    positions = cache_index[:, None]                          # (B, 1)
    q, k, v = _project_qkv(params, cfg, x, positions)
    slot = (cache_index % Smax if cfg.window
            else torch.clamp(cache_index, max=Smax - 1))
    n_valid = torch.clamp(cache_index + 1, max=Smax)
    if impl == "seqsharded":
        mesh = get_mesh()
        if mesh is None:
            raise ValueError("impl='seqsharded' needs distributed.context"
                             ".set_mesh(mesh)")
        new_k = seqsharded_write(mesh, cache["k"], k[:, 0], slot)
        new_v = seqsharded_write(mesh, cache["v"], v[:, 0], slot)
        out = plain_like(make_seqsharded_decode_attn(mesh)(
            q[:, 0], new_k, new_v, n_valid), x)
        out = out.reshape(B, cfg.q_dim) @ params["wo"]
        return out[:, None, :], {"k": new_k, "v": new_v}
    bidx = torch.arange(B, device=x.device)
    new_k = cache["k"].clone()
    new_v = cache["v"].clone()
    new_k[bidx, slot] = k[:, 0]
    new_v[bidx, slot] = v[:, 0]
    if impl == "paged":
        out = pa_ops.decode_attention_dense(q[:, 0], new_k, new_v, n_valid)
    elif impl == "flash_jnp":
        out = _sdpa_flash_decode(q[:, 0], new_k, new_v, n_valid)
    else:
        valid = (torch.arange(Smax, device=x.device)[None, :]
                 < n_valid[:, None])
        out = _sdpa(q, new_k, new_v, valid[:, None, :])[:, 0]
    out = out.reshape(B, cfg.q_dim) @ params["wo"]
    return out[:, None, :], {"k": new_k, "v": new_v}


def attention_decode_deferred(params: Params, cfg: ModelConfig,
                              x: torch.Tensor, cache: Dict,
                              cache_index: torch.Tensor, *,
                              impl: str = "reference"
                              ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode with a READ-ONLY cache.  The new token's (k, v)
    are not written: they come back as the delta ``{"k_new", "v_new"}``
    (B, Hkv, D) for the caller's one scatter per step
    (``models.model.decode_step_deferred``).  Attention over the cache's
    ``min(index, Smax)`` old entries (``decode_attn_partials``) is merged
    with the new token's own logit in fp32 (``merge_softmax_groups``).
    Under a window, once the ring is full the slot the new token will
    overwrite holds position ``index - Smax``, outside the window: it is
    masked out.  ``impl="seqsharded"`` computes the partials over the
    sequence-sharded cache of the ambient mesh (``min(index, Smax)``
    entries, as in JAX); every other ``impl`` takes the path above."""
    B = x.shape[0]
    Smax = cache["k"].shape[1]
    positions = cache_index[:, None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]                 # (B, H*, D)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G = H // Hkv
    n_valid = torch.clamp(cache_index, max=Smax)
    if impl == "seqsharded":
        mesh = get_mesh()
        if mesh is None:
            raise ValueError("impl='seqsharded' needs set_mesh(mesh)")
        out1, m1, l1 = (plain_like(t, x) for t in
                        make_seqsharded_decode_attn_partials(mesh)(
                            q1, cache["k"], cache["v"], n_valid))
    else:
        sidx = torch.arange(Smax, device=x.device)[None, :]
        valid = sidx < n_valid[:, None]
        if cfg.window:
            expired = ((sidx == (cache_index % Smax)[:, None])
                       & (cache_index[:, None] >= Smax))
            valid &= ~expired
        out1, m1, l1 = decode_attn_partials(q1, cache["k"], cache["v"],
                                            valid)
    # the new token's own logit and value per query head
    qg = q1.reshape(B, Hkv, G, D).float()
    s2 = torch.einsum("bhgd,bhd->bhg", qg, k1.float()) / math.sqrt(D)
    v2 = v1.float()[:, :, None, :].expand(B, Hkv, G, D)
    out = merge_softmax_groups(
        out1.reshape(B, Hkv, G, D), m1.reshape(B, Hkv, G),
        l1.reshape(B, Hkv, G), s2, v2)
    out = out.reshape(B, cfg.q_dim).to(x.dtype) @ params["wo"]
    return out[:, None, :], {"k_new": k1, "v_new": v1}
