"""GQA attention with a dense KV cache: ``repro.models.attention`` for
unbounded dense attention.

* full-sequence (train / prefill): causal (+ optional prefix-LM)
  attention over the whole batch, optionally emitting a cache padded to
  ``cache_len``.  ``impl="flash"`` runs the hand-written flash-attention
  kernel (``kernels.flash_attention``, forward-only); every other
  ``impl`` the plain reference branch, as in the JAX package.
* chunked prefill (``attention_chunk``): the next c tokens of each row
  against an existing cache, with a ``length`` mask for the engine's
  bucketed rounds (the slot-resident planes' chunk step).
* decode: one query token against a dense cache ``(B, S, Hkv, D)`` with
  a per-request length mask.  ``impl`` picks the backend as in JAX:
  ``"paged"`` views the contiguous cache as 64-token pages and runs the
  hand-written paged decode kernel (``kernels.paged_attention.ops.
  decode_attention_dense``, B1), ``"flash_jnp"`` the chunked online-
  softmax loop (``_sdpa_flash_decode``), anything else the reference
  branch.  ``attention_decode_deferred`` reads a read-only cache and
  returns the new token's K/V for the caller's one scatter per step.

These are the token oracle (``serving.engine.generate_reference``), the
trainer's attention, the slot-resident planes' attention and the
model-level parity surface.  The engine's pooled plane runs the paged
kernels through ``serving.paged_plane`` instead.  Sliding windows
(ROADMAP A8) and the sequence-sharded decode backend (``impl=
"seqsharded"``, A13) raise ``ValueError`` naming their item.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import decode_attn_partials
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.common import (Params, apply_rope, causal_mask,
                                       dense_init, rms_norm)

NEG_INF = -1e30

#: decode backends of the JAX package that this port does not have yet
_DECODE_IMPL_ITEMS = {"seqsharded": "A13"}


def _check_window(cfg: ModelConfig) -> None:
    if cfg.window:
        raise ValueError(f"{cfg.name}: sliding-window attention is not "
                         "ported yet (ROADMAP A8)")


def _check_decode_impl(impl: str) -> None:
    if impl in _DECODE_IMPL_ITEMS:
        raise ValueError(f"decode impl={impl!r} is not ported yet (ROADMAP "
                         f"{_DECODE_IMPL_ITEMS[impl]})")


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
    q = (x @ params["wq"]).reshape(B, S, H, D)
    k = (x @ params["wk"]).reshape(B, S, Hkv, D)
    v = (x @ params["wv"]).reshape(B, S, Hkv, D)
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
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def attention_full(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, *, prefix_len: int = 0,
                   impl: str = "reference", cache_len: int = 0
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Train / prefill attention.  Returns (out, cache_or_None);
    ``cache_len`` >= S also emits a KV cache zero-padded to that length.
    ``impl="flash"`` assumes ``positions`` are ``0..S-1`` on every row,
    as the JAX kernel does."""
    _check_window(cfg)
    B, S, _ = x.shape
    if cache_len and cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}: only "
                         "the sliding-window ring crops (ROADMAP A8)")
    q, k, v = _project_qkv(params, cfg, x, positions)
    if impl == "flash":
        out = fa_ops.flash_attention(q, k, v, prefix_len=prefix_len)
    else:
        out = _sdpa(q, k, v, causal_mask(positions, positions,
                                         prefix_len=prefix_len))
    out = out.reshape(B, S, cfg.q_dim) @ params["wo"]
    cache = None
    if cache_len:
        pad = (0, 0, 0, 0, 0, cache_len - S)
        cache = {"k": torch.nn.functional.pad(k, pad),
                 "v": torch.nn.functional.pad(v, pad)}
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
    """
    _check_window(cfg)
    B, c, _ = x.shape
    Smax = cache["k"].shape[1]
    if c > Smax:
        raise ValueError(f"chunk of {c} tokens > cache length {Smax}")
    ar = torch.arange(c, device=x.device)
    positions = start.long()[:, None] + ar[None, :]            # (B, c)
    q, k, v = _project_qkv(params, cfg, x, positions)
    dest = (positions % Smax)[:, :, None, None].expand_as(k)
    if length is not None:
        valid = (ar[None, :] < length[:, None])[:, :, None, None]
        k = torch.where(valid, k, cache["k"].gather(1, dest))
        v = torch.where(valid, v, cache["v"].gather(1, dest))
    new_k = cache["k"].clone().scatter_(1, dest, k)
    new_v = cache["v"].clone().scatter_(1, dest, v)
    mask = (torch.arange(Smax, device=x.device)[None, None, :]
            <= positions[:, :, None])                          # causal
    out = _sdpa(q, new_k, new_v, mask)
    out = out.reshape(B, c, cfg.q_dim) @ params["wo"]
    return out, {"k": new_k, "v": new_v}


def attention_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict, cache_index: torch.Tensor, *,
                     impl: str = "reference") -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); cache[k|v]: (B, Smax, Hkv, D);
    cache_index: (B,) number of valid cache entries (also the position).
    The new token is written, then attended (``min(index + 1, Smax)``
    keys), by the backend ``impl`` picks (module docstring).  Returns new
    cache tensors; the inputs are not modified."""
    _check_window(cfg)
    _check_decode_impl(impl)
    B = x.shape[0]
    Smax = cache["k"].shape[1]
    positions = cache_index[:, None]                          # (B, 1)
    q, k, v = _project_qkv(params, cfg, x, positions)
    slot = torch.clamp(cache_index, max=Smax - 1)
    bidx = torch.arange(B, device=x.device)
    new_k = cache["k"].clone()
    new_v = cache["v"].clone()
    new_k[bidx, slot] = k[:, 0]
    new_v[bidx, slot] = v[:, 0]
    n_valid = torch.clamp(cache_index + 1, max=Smax)
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
    Every ``impl`` but ``"seqsharded"`` (A13) takes this path, as in
    JAX."""
    _check_window(cfg)
    _check_decode_impl(impl)
    B = x.shape[0]
    Smax = cache["k"].shape[1]
    positions = cache_index[:, None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]                 # (B, H*, D)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G = H // Hkv
    n_valid = torch.clamp(cache_index, max=Smax)
    valid = (torch.arange(Smax, device=x.device)[None, :]
             < n_valid[:, None])
    out1, m1, l1 = decode_attn_partials(q1, cache["k"], cache["v"], valid)
    # the new token's own logit and value per query head
    qg = q1.reshape(B, Hkv, G, D).float()
    s2 = torch.einsum("bhgd,bhd->bhg", qg, k1.float()) / math.sqrt(D)
    v2 = v1.float()[:, :, None, :].expand(B, Hkv, G, D)
    out = merge_softmax_groups(
        out1.reshape(B, Hkv, G, D), m1.reshape(B, Hkv, G),
        l1.reshape(B, Hkv, G), s2, v2)
    out = out.reshape(B, cfg.q_dim).to(x.dtype) @ params["wo"]
    return out[:, None, :], {"k_new": k1, "v_new": v1}
