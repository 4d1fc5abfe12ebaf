"""GQA attention with a dense KV cache: ``repro.models.attention`` for
unbounded dense attention.

* full-sequence (train / prefill): causal (+ optional prefix-LM)
  attention over the whole batch, optionally emitting a cache padded to
  ``cache_len``.  ``impl="flash"`` runs the hand-written flash-attention
  kernel (``kernels.flash_attention``, forward-only); every other
  ``impl`` the plain reference branch, as in the JAX package.
* decode: one query token against a dense cache ``(B, S, Hkv, D)`` with
  a per-request length mask (the reference branch).

These are the token oracle (``serving.engine.generate_reference``), the
trainer's attention and the model-level parity surface.  The serving
engine's paged plane runs the hand-written paged kernels instead
(``kernels.paged_attention``).  Sliding windows (ROADMAP A8) and the
kernel/sequence-sharded decode backends are not part of this port yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import (Params, apply_rope, causal_mask,
                                       dense_init, rms_norm)

NEG_INF = -1e30


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
    if cfg.window:
        raise ValueError(f"{cfg.name}: sliding-window attention is not "
                         "ported yet (ROADMAP A8)")
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


def attention_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict, cache_index: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); cache[k|v]: (B, Smax, Hkv, D);
    cache_index: (B,) number of valid cache entries (also the position).
    Returns new cache tensors; the inputs are not modified."""
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
    valid = (torch.arange(Smax, device=x.device)[None, :]
             < n_valid[:, None])
    out = _sdpa(q, new_k, new_v, valid[:, None, :])[:, 0]
    out = out.reshape(B, cfg.q_dim) @ params["wo"]
    return out[:, None, :], {"k": new_k, "v": new_v}
