"""Decoder-LM assembly for the dense family: a Python loop over layers
whose parameters are stacked on a leading ``L`` axis, as in
``repro.models.model`` (``lax.scan`` there).

Public API (functional, on nested dicts of tensors):
  init_params(cfg, seed, device=...)          -> params
  params_from_jax(tree_of_numpy, device=...)  -> params
  train_loss(cfg, params, batch, impl=...)    -> scalar loss
  prefill(cfg, params, batch, cache_len, impl=...) -> (last_logits, cache)
  decode_step(cfg, params, tokens, cache, impl=...) -> (logits, cache)
  init_cache(cfg, batch, cache_len, device=...) -> cache

``impl="flash"`` runs the full-sequence attention of ``train_loss`` and
``prefill`` on the hand-written flash-attention kernel (forward-only:
a backward through it raises, as the JAX package has none either);
decode takes the reference branch for it, as in JAX.

The cache dict carries "index" (B,) = tokens already in context (== next
absolute position), plus "k"/"v" of shape (L, B, cache_len, Hkv, D).
Only the dense, unbounded-attention family is ported: mixture-of-experts,
sliding-window/hybrid, RWKV and the VLM/audio frontends raise
``ValueError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (Params, embed_init, gated_mlp,
                                       gated_mlp_init, rms_norm,
                                       softmax_cross_entropy)


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


def unstack_layers(params: Params) -> List[Params]:
    """Every layer's slice of the stacked per-layer params (views), from
    ONE ``unbind`` per stacked leaf: its backward stacks the L per-layer
    gradients once, where a ``select`` per layer would scatter each into
    a zeroed copy of the whole stacked leaf (O(L^2) bytes in
    ``train_loss``'s backward)."""
    def split(tree):
        out = [{} for _ in range(L)]
        for k, v in tree.items():
            parts = split(v) if isinstance(v, dict) else torch.unbind(v)
            for l in range(L):
                out[l][k] = parts[l]
        return out
    L = params["layers"]["ln1"].shape[0]
    return split(params["layers"])


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


def _block_full(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                positions: torch.Tensor, impl: str,
                cache_len: int) -> Tuple[torch.Tensor, Dict]:
    """One full-sequence transformer block: (x, layer cache or {}).  No
    prefix-LM here: the frontends that make one are not ported (A10)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, kv = attn.attention_full(lp["attn"], cfg, h, positions, impl=impl,
                                cache_len=cache_len)
    x = x + a
    x = x + gated_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x, (kv if cache_len else {})


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


def train_loss(cfg: ModelConfig, params: Params,
               batch: Dict[str, torch.Tensor], *, impl: str = "reference",
               remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S)
    against ``batch["labels"]`` (labels < 0 masked).  ``remat`` keeps
    only each layer's input for the backward and recomputes the layer
    (``jax.checkpoint`` of the layer body in the JAX package)."""
    check_supported(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    positions = _positions(tokens)
    x = _embed(cfg, params, tokens)

    def body(xc, lp):
        return _block_full(cfg, lp, xc, positions, impl, 0)[0]

    for lp in unstack_layers(params):
        x = (checkpoint(body, x, lp, use_reentrant=False) if remat
             else body(x, lp))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return softmax_cross_entropy(_logits(cfg, params, x), labels,
                                 cfg.vocab_size)


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache_len: int, *, impl: str = "reference"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the whole prompt ``batch["tokens"]`` (B, S); returns
    (last-token logits (B, Vpad), cache padded to ``cache_len``).  An
    optional ``batch["length"]`` (B,) sets the cache's ``index`` (the
    logits stay the last position's, as in JAX)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(tokens)
    x = _embed(cfg, params, tokens)
    ks, vs = [], []
    for lp in unstack_layers(params):
        x, kv = _block_full(cfg, lp, x, positions, impl, cache_len)
        if cache_len:
            ks.append(kv["k"])
            vs.append(kv["v"])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _logits(cfg, params, x[:, -1])
    length = batch.get("length")
    index = (torch.full((B,), S, dtype=torch.int32, device=tokens.device)
             if length is None else length.to(torch.int32))
    cache: Dict[str, torch.Tensor] = {"index": index}
    if cache_len:
        cache["k"] = torch.stack(ks)
        cache["v"] = torch.stack(vs)
    return logits, cache


#: decode backends of the JAX package that this port does not have yet
_DECODE_IMPL_ITEMS = {"paged": "A5", "flash_jnp": "A5", "seqsharded": "A13"}


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], *, impl: str = "reference"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B,) or (B, 1); one decode step.  Returns (logits (B, Vpad),
    a new cache with index + 1); the input cache is not modified.
    ``impl`` "reference" and "flash" (and any other the JAX package
    sends to its reference branch) take the reference decode."""
    check_supported(cfg)
    if impl in _DECODE_IMPL_ITEMS:
        raise ValueError(f"decode impl={impl!r} is not ported yet (ROADMAP "
                         f"{_DECODE_IMPL_ITEMS[impl]})")
    if tokens.ndim == 1:
        tokens = tokens[:, None]
    index = cache["index"]
    x = _embed(cfg, params, tokens)
    ks, vs = [], []
    for l, lp in enumerate(unstack_layers(params)):
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
