"""Decoder-LM assembly for the dense family: a Python loop over layers
whose parameters are stacked on a leading ``L`` axis, as in
``repro.models.model`` (``lax.scan`` there).

Public API (functional, on nested dicts of tensors):
  init_params(cfg, seed, device=...)          -> params
  params_from_jax(tree_of_numpy, device=...)  -> params
  prefill(cfg, params, batch, cache_len)      -> (last_logits, cache)
  decode_step(cfg, params, tokens, cache)     -> (logits, cache)
  init_cache(cfg, batch, cache_len, device=...) -> cache

The cache dict carries "index" (B,) = tokens already in context (== next
absolute position), plus "k"/"v" of shape (L, B, cache_len, Hkv, D).
Only the dense, unbounded-attention family is ported: mixture-of-experts,
sliding-window/hybrid, RWKV and the VLM/audio frontends raise
``ValueError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (Params, embed_init, gated_mlp,
                                       gated_mlp_init, rms_norm)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is a family this port runs."""
    if cfg.num_experts:
        raise ValueError(f"{cfg.name}: mixture-of-experts layers are not "
                         "ported yet (ROADMAP A7)")
    if cfg.window or cfg.family == "hybrid":
        raise ValueError(f"{cfg.name}: sliding-window/hybrid attention is "
                         "not ported yet (ROADMAP A8)")
    if cfg.family == "ssm":
        raise ValueError(f"{cfg.name}: RWKV6 is not ported yet (ROADMAP A9)")
    if cfg.family != "dense" or cfg.frontend != "none":
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family/frontends "
                         "are not ported yet (ROADMAP A10)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------- #


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str = "cuda") -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``,
    with ``repro``'s init scales (embeddings N(0, 0.02), projections
    N(0, 1/in_dim), norm scales 0, i.e. ``1 + 0``) and its tree: the
    per-layer leaves stacked on a leading ``L`` axis."""
    check_supported(cfg)
    dtype, lead = _dtype(cfg), (cfg.num_layers,)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    d = cfg.d_model
    layers: Params = {
        "ln1": zeros(*lead, d), "ln2": zeros(*lead, d),
        "attn": attn.init_attention(gen, cfg, dtype, lead),
        "mlp": gated_mlp_init(gen, d, cfg.d_ff, dtype, lead)}
    params: Params = {"embed": embed_init(gen, cfg.padded_vocab, d, dtype),
                      "ln_f": zeros(d), "layers": layers}
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.padded_vocab, d, dtype)
    return params


def params_from_jax(tree: Mapping[str, Any], *,
                    device: str = "cuda") -> Params:
    """Convert ``repro.models.model.init_params``'s pytree, already
    turned into numpy arrays (``jax.tree.map(np.asarray, params)``), to
    torch tensors on ``device``.  Keys, the stacked leading ``L`` axis of
    ``params["layers"]`` and the ``(in, out)`` weight layout are kept, so
    every function here reads the same leaf the JAX one reads."""
    out: Params = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_from_jax(v, device=device)
        else:
            arr = np.asarray(v)
            if arr.dtype.name == "bfloat16":       # ml_dtypes bfloat16
                t = torch.from_numpy(np.array(arr).view(
                    np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))        # own, writable
            out[k] = t.to(device)
    return out


def layer_params(params: Params, l: int) -> Params:
    """Layer ``l``'s slice of the stacked per-layer params (views)."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[l]
                for k, v in tree.items()}
    return take(params["layers"])


# --------------------------------------------------------------------- #
# blocks / embedding / head
# --------------------------------------------------------------------- #


def _embed(cfg: ModelConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding (dense family: no scaling, no frontend)."""
    return params["embed"][tokens]


def _logits(cfg: ModelConfig, params: Params,
            x: torch.Tensor) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return torch.einsum("...d,vd->...v", x, head)


# --------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------- #


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: str = "cuda", dtype=None) -> Dict[str, torch.Tensor]:
    check_supported(cfg)
    dtype = dtype or _dtype(cfg)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
             cfg.head_dim_)
    return {"index": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the whole prompt ``batch["tokens"]`` (B, S); returns
    (last-token logits (B, Vpad), cache padded to ``cache_len``)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = _embed(cfg, params, tokens)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, kv = attn.attention_full(lp["attn"], cfg, h, positions,
                                    cache_len=cache_len)
        x = x + a
        x = x + gated_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        if cache_len:
            ks.append(kv["k"])
            vs.append(kv["v"])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _logits(cfg, params, x[:, -1])
    cache: Dict[str, torch.Tensor] = {
        "index": torch.full((B,), S, dtype=torch.int32,
                            device=tokens.device)}
    if cache_len:
        cache["k"] = torch.stack(ks)
        cache["v"] = torch.stack(vs)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B,) or (B, 1); one decode step.  Returns (logits (B, Vpad),
    a new cache with index + 1); the input cache is not modified."""
    check_supported(cfg)
    if tokens.ndim == 1:
        tokens = tokens[:, None]
    index = cache["index"]
    x = _embed(cfg, params, tokens)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, kv = attn.attention_decode(lp["attn"], cfg, h,
                                      {"k": cache["k"][l],
                                       "v": cache["v"][l]}, index)
        x = x + a
        x = x + gated_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        ks.append(kv["k"])
        vs.append(kv["v"])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _logits(cfg, params, x[:, 0])
    return logits, {"index": index + 1, "k": torch.stack(ks),
                    "v": torch.stack(vs)}
