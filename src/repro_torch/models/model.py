"""Decoder-LM assembly for every family of ``repro.models.model``: dense,
mixture-of-experts, RWKV6 (``ssm``), hybrid (hymba), ``vlm`` (PaliGemma)
and ``audio`` (MusicGen); a Python loop over layers whose parameters are
stacked on a leading ``L`` axis (``lax.scan`` there).

Public API (functional, on nested dicts of tensors):
  init_params(cfg, seed, device=...)          -> params
  params_from_jax(tree_of_numpy, device=...)  -> params
  train_loss(cfg, params, batch, impl=...)    -> scalar loss
  prefill(cfg, params, batch, cache_len, impl=...) -> (last_logits, cache)
  prefill_chunk(cfg, params, tokens, cache, length=...) -> (logits, cache)
  decode_step(cfg, params, tokens, cache, impl=...) -> (logits, cache)
  decode_step_deferred(cfg, params, tokens, cache, impl=...)
                                              -> (logits, cache)
  init_cache(cfg, batch, cache_len, device=...) -> cache

``impl="flash"`` runs the full-sequence attention of ``train_loss`` and
``prefill`` on the hand-written flash-attention kernel (forward-only:
a backward through it raises, as the JAX package has none either);
decode takes the reference branch for it, as in JAX.  The dense decode's
``impl="paged"`` runs the paged decode kernel on the contiguous cache
and ``"flash_jnp"`` the chunked online-softmax loop
(``models.attention``); ``"seqsharded"`` flash-decodes a cache whose
sequence is sharded over the ambient mesh (``distributed.context.
set_mesh``), the cache leaves staying DTensors sharded on the sequence.

The cache dict carries "index" (B,) = tokens already in context (== next
absolute position), plus, for the dense family, "k"/"v" of shape
(L, B, cache_len, Hkv, D) (under a sliding window, a ring of
``min(cache_len, window)`` slots), for RWKV6 the recurrent state "S"
(L, B, H, D, D) fp32 and the token-shift samples "x_tm"/"x_cm"
(L, B, 1, d), and for the hybrid family the ring "k"/"v" beside the
selective SSM's state "h" (L, B, d_inner, N) fp32 and conv window "conv"
(L, B, 3, d_inner).  RWKV6's full-sequence time-mix runs on the WKV6
kernel (``kernels.rwkv_scan``), forward-only as JAX's is; ``train_loss``
runs it on the closed chunked form under autograd instead, the
arithmetic the JAX model trains through.  ``prefill_chunk`` (the slot
planes' chunk step) and ``decode_step_deferred`` (one cache scatter per
step) run every family.  The MoE family's MLP is ``models.moe``'s
dispatch chosen by ``moe_impl`` (``"dense"``, ``"sparse"``, and ``"ep"``,
expert parallelism over the ambient mesh), with JAX's defaults:
``"sparse"`` in the model functions, ``"dense"`` in the engine; every
dispatch trains.  The hybrid family's
layer runs windowed attention and the selective SSM (``models.ssm``,
plain torch as in JAX; its scan differentiated by ``ssm.ChunkScan``)
side by side on the same input and adds the mean of their normalized
outputs.  Every family trains through ``train_loss``.

Every entry point runs under ``distributed.context.spmd_scope``: params,
batches or caches may be DTensors on a device mesh (the counterpart of
GSPMD-sharded arrays), and the plain tensors the functions make
(positions, masks) meet them as replicated values.  The token embedding
is ``F.embedding``, vocab-parallel over a vocab-sharded table
(``distributed.collectives.embedding``).

The frontends (``_embed``) are JAX's stubs.  A ``vlm`` model scales its
token embeddings by ``sqrt(d_model)`` (rounded to the params' dtype, as
JAX casts it) and runs a GELU MLP; given ``batch["patch_embeds"]`` (B, P,
d), ``prefill`` and ``train_loss`` project them with ``patch_proj`` and
put them in front of the text as a bidirectional prefix (prefix-LM: every
query sees the P patch positions), the cache and ``index`` count them,
and ``train_loss`` crops them before the head.  An ``audio`` model adds a
sinusoidal position embedding (``common.sinusoidal_pos_emb``, fp32, cast
to the params' dtype) at every absolute position: the prompt's, a
chunk's ``start + j`` and a decode row's ``index``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import embedding, seqsharded_write
from repro_torch.distributed.context import (get_mesh, plain_like,
                                             replicated, spmd)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (Params, embed_init, gated_mlp,
                                       gated_mlp_init, rms_norm,
                                       sinusoidal_pos_emb,
                                       softmax_cross_entropy)


#: the families and stub frontends of ``repro.configs``
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
FRONTENDS = ("none", "patch", "frames")


def check_supported(cfg: ModelConfig, *, train: bool = False) -> None:
    """Raise ``ValueError`` unless ``cfg`` is a family this port runs;
    every family it runs, it also trains (``train``)."""
    if cfg.family not in FAMILIES or cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} or "
                         f"frontend {cfg.frontend!r}")


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
    layers: Params = {"ln1": zeros(*lead, d), "ln2": zeros(*lead, d)}
    if cfg.family == "ssm":
        layers.update(rwkv_mod.init_rwkv_layer(gen, cfg, dtype, lead))
    else:
        layers["attn"] = attn.init_attention(gen, cfg, dtype, lead)
        if cfg.family == "hybrid":
            layers["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, lead)
            layers["ln_attn"] = zeros(*lead, d)
            layers["ln_ssm"] = zeros(*lead, d)
        if cfg.num_experts:
            layers["moe"] = moe_mod.init_moe(gen, cfg, dtype, lead)
        else:
            layers["mlp"] = gated_mlp_init(gen, d, cfg.d_ff, dtype, lead)
    params: Params = {"embed": embed_init(gen, cfg.padded_vocab, d, dtype),
                      "ln_f": zeros(d), "layers": layers}
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.padded_vocab, d, dtype)
    if cfg.frontend == "patch":
        # the stub projection of the precomputed patch embeddings
        params["patch_proj"] = embed_init(gen, d, d, dtype)
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


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           positions: torch.Tensor,
           patch_embeds: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, int]:
    """(x (B, S', d), prefix_len): the token embeddings of ``tokens`` (B,
    S) at absolute ``positions`` (B, S), through the family's frontend
    (module docstring); ``S' = P + S`` and ``prefix_len = P`` when a
    ``patch`` model is given ``patch_embeds`` (B, P, d), else S and 0."""
    x = embedding(tokens, params["embed"])
    prefix_len = 0
    if cfg.family == "vlm":
        x = x * _vlm_scale(cfg.d_model, x.dtype)
    if cfg.frontend == "patch" and patch_embeds is not None:
        pe = patch_embeds.to(x.dtype) @ params["patch_proj"]
        x = torch.cat([pe, x], dim=1)
        prefix_len = patch_embeds.shape[1]
    if cfg.family == "audio":
        pos = positions if prefix_len == 0 else \
            torch.arange(x.shape[1], device=x.device)[None, :]
        x = x + sinusoidal_pos_emb(pos, cfg.d_model).to(x.dtype)
    return x, prefix_len


@functools.lru_cache(maxsize=None)
def _vlm_scale(d_model: int, dtype: torch.dtype) -> float:
    """``sqrt(d_model)`` in fp32 rounded to ``dtype``, as JAX casts it
    before the product (a host scalar: no device tensor is made)."""
    return torch.tensor(math.sqrt(d_model), dtype=torch.float32) \
        .to(dtype).item()


def _logits(cfg: ModelConfig, params: Params,
            x: torch.Tensor) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return torch.einsum("...d,vd->...v", x, head)


# --------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------- #


#: the recurrent-state leaves of an RWKV6 cache, each stacked on L
SSM_LEAVES = ("S", "x_tm", "x_cm")
#: the leaves of a hybrid cache: the attention ring and the SSM state
HYBRID_LEAVES = ("k", "v", "h", "conv")


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: str = "cuda", dtype=None) -> Dict[str, torch.Tensor]:
    check_supported(cfg)
    if cfg.family == "ssm":          # O(1) state: cache_len plays no part
        st = rwkv_mod.init_rwkv_state(cfg, batch, device=device)
        cache = {"index": torch.zeros((batch,), dtype=torch.int32,
                                      device=device)}
        cache.update({k: torch.stack([st[k]] * cfg.num_layers)
                      for k in SSM_LEAVES})
        return cache
    dtype = dtype or _dtype(cfg)
    L = cfg.num_layers
    eff_len = min(cache_len, cfg.window) if cfg.window else cache_len
    shape = (L, batch, eff_len, cfg.num_kv_heads, cfg.head_dim_)
    cache = {"index": torch.zeros((batch,), dtype=torch.int32,
                                  device=device),
             "k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family == "hybrid":
        st = ssm_mod.init_ssm_state(cfg, batch, device=device)
        cache.update({k: torch.stack([v] * L) for k, v in st.items()})
    return cache


def _rwkv_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                state: Dict[str, torch.Tensor],
                length: Optional[torch.Tensor] = None, scan: str = "kernel"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One RWKV6 block (time-mix + channel-mix) continuing from the
    layer's ``state``; ``length`` (B,) marks each row's real prefix;
    ``scan`` is the time-mix's (``rwkv.rwkv_time_mix_full``)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, st = rwkv_mod.rwkv_time_mix_full(lp, cfg, h, state, length=length,
                                        scan=scan)
    x = x + y
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    cm, st["x_cm"] = rwkv_mod.rwkv_channel_mix(lp, cfg, h2, state["x_cm"],
                                               length=length)
    return x + cm, st


def _mlp_or_moe(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                moe_impl: str, valid: Optional[torch.Tensor] = None,
                stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block's MLP: the MoE dispatch ``moe_impl`` on the MoE family,
    else the gated MLP.  ``valid`` (the live tokens) and ``stats`` (the
    layer's row accumulators) reach the grouped dispatch only."""
    if cfg.num_experts:
        if moe_impl not in moe_mod.DISPATCH:
            raise ValueError(f"unknown moe_impl {moe_impl!r}")
        kw = dict(valid=valid, stats=stats) if moe_impl == "grouped" else {}
        # plain activations come back plain (``moe_impl="ep"`` returns a
        # DTensor): the serving engine over a mesh keeps them plain
        return plain_like(moe_mod.DISPATCH[moe_impl](lp["moe"], cfg, x,
                                                     **kw), x)
    return gated_mlp(lp["mlp"], x, act="gelu" if cfg.family == "vlm"
                     else "silu")


def _hybrid_mix(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The hybrid layer's residual: the mean of the normalized attention
    and SSM branch outputs."""
    return x + 0.5 * (rms_norm(a, lp["ln_attn"], cfg.norm_eps)
                      + rms_norm(s, lp["ln_ssm"], cfg.norm_eps))


def _mlp_residual(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                  moe_impl: str) -> torch.Tensor:
    return x + _mlp_or_moe(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps),
                           moe_impl)


def _block_full(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                positions: torch.Tensor, prefix_len: int, impl: str,
                moe_impl: str, cache_len: int, train: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
    """One full-sequence block: (x, layer cache or {}); an RWKV6 block
    starts from a zero state and always returns its state, a hybrid one
    (with a cache) returns its ring cropped to the window and its SSM
    state.  The first ``prefix_len`` positions are a bidirectional
    prefix (prefix-LM) of the attention.  ``train`` runs RWKV6's time-mix
    on the differentiable chunked form, as the JAX model trains it,
    instead of the forward-only WKV6 kernel."""
    if cfg.family == "ssm":
        state = rwkv_mod.init_rwkv_state(cfg, x.shape[0], device=x.device)
        return _rwkv_block(cfg, lp, x, state,
                           scan="chunked" if train else "kernel")
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "hybrid":
        a, kv = attn.attention_full(
            lp["attn"], cfg, h, positions, prefix_len=prefix_len, impl=impl,
            cache_len=min(cache_len, cfg.window) if cache_len else 0)
        s, sst = ssm_mod.apply_ssm_full(lp["ssm"], cfg, h)
        x = _hybrid_mix(cfg, lp, x, a, s)
        lc = {**(kv or {}), **sst}
    else:
        a, lc = attn.attention_full(lp["attn"], cfg, h, positions,
                                    prefix_len=prefix_len, impl=impl,
                                    cache_len=cache_len)
        x = x + a
    return _mlp_residual(cfg, lp, x, moe_impl), (lc if cache_len else {})


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


@spmd
def train_loss(cfg: ModelConfig, params: Params,
               batch: Dict[str, torch.Tensor], *, impl: str = "reference",
               moe_impl: str = "sparse", remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S)
    against ``batch["labels"]`` (labels < 0 masked); a ``patch`` model's
    ``batch["patch_embeds"]`` go in front as the prefix and are cropped
    before the head.  ``remat`` keeps only each layer's input for the
    backward and recomputes the layer (``jax.checkpoint`` of the layer
    body in the JAX package).  Vocab-sharded logits are gathered over
    the ``model`` axis before the loss (DTensor's sharded ``gather``
    mis-reduces there)."""
    check_supported(cfg, train=True)
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    x, prefix_len = _embed(cfg, params, tokens,
                           _positions(B, S, tokens.device),
                           batch.get("patch_embeds"))
    pos_x = _positions(B, x.shape[1], tokens.device)

    def body(xc, lp):
        return _block_full(cfg, lp, xc, pos_x, prefix_len, impl, moe_impl,
                           0, train=True)[0]

    for lp in unstack_layers(params):
        x = (checkpoint(body, x, lp, use_reentrant=False) if remat
             else body(x, lp))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)[:, prefix_len:]
    return softmax_cross_entropy(replicated(_logits(cfg, params, x),
                                            "model"),
                                 labels, cfg.vocab_size)


@spmd
def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache_len: int, *, impl: str = "reference",
            moe_impl: str = "sparse"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the whole prompt ``batch["tokens"]`` (B, S), behind a
    ``patch`` model's ``batch["patch_embeds"]`` (B, P, d) if given;
    returns (last-token logits (B, Vpad), cache of the P + S positions
    padded to ``cache_len``).  An optional ``batch["length"]`` (B,) sets
    the cache's ``index`` to ``length + P`` (the logits stay the last
    position's, as in JAX)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, prefix_len = _embed(cfg, params, tokens,
                           _positions(B, S, tokens.device),
                           batch.get("patch_embeds"))
    Sx = x.shape[1]
    pos_x = _positions(B, Sx, tokens.device)
    layer_caches = []
    for lp in unstack_layers(params):
        x, lc = _block_full(cfg, lp, x, pos_x, prefix_len, impl, moe_impl,
                            cache_len)
        layer_caches.append(lc)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _logits(cfg, params, x[:, -1])
    length = batch.get("length")
    index = (torch.full((B,), Sx, dtype=torch.int32, device=tokens.device)
             if length is None else (length + prefix_len).to(torch.int32))
    cache: Dict[str, torch.Tensor] = {"index": index}
    cache.update(_stack(layer_caches))
    return logits, cache


def _stack(layer_caches: List[Dict[str, torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    """Per-layer cache dicts -> one dict of leaves stacked on L."""
    if not layer_caches or not layer_caches[0]:
        return {}
    return {k: torch.stack([lc[k] for lc in layer_caches])
            for k in layer_caches[0]}


def _block_chunk(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 layer_cache: Dict[str, torch.Tensor], start: torch.Tensor,
                 impl: str, moe_impl: str, length: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked-prefill block continuing from the layer's cache (JAX's
    ``_block_chunk``): x (B, c, d), ``start`` (B,) the chunk's first
    position; ``length`` (B,) marks each row's real prefix, and padded
    steps leave the cache and state as they were."""
    if cfg.family == "ssm":
        return _rwkv_block(cfg, lp, x, layer_cache, length)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    kv = {"k": layer_cache["k"], "v": layer_cache["v"]}
    a, lc = attn.attention_chunk(lp["attn"], cfg, h, kv, start, impl=impl,
                                 length=length)
    if cfg.family == "hybrid":
        s, sst = ssm_mod.apply_ssm_full(
            lp["ssm"], cfg, h, length=length,
            state={"h": layer_cache["h"], "conv": layer_cache["conv"]})
        x = _hybrid_mix(cfg, lp, x, a, s)
        lc.update(sst)
    else:
        x = x + a
    return _mlp_residual(cfg, lp, x, moe_impl), lc


def _block_decode(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                  layer_cache: Dict[str, torch.Tensor],
                  index: torch.Tensor, impl: str, moe_impl: str,
                  deferred: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode block of the attention families: (x, the layer's new
    cache), or with ``deferred`` (x, its delta: the new token's
    ``k_new``/``v_new``, and a hybrid layer's whole new SSM state)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    kv = {"k": layer_cache["k"], "v": layer_cache["v"]}
    fn = (attn.attention_decode_deferred if deferred
          else attn.attention_decode)
    a, lc = fn(lp["attn"], cfg, h, kv, index, impl=impl)
    if cfg.family == "hybrid":
        s, sst = ssm_mod.apply_ssm_decode(
            lp["ssm"], cfg, h,
            {"h": layer_cache["h"], "conv": layer_cache["conv"]})
        x = _hybrid_mix(cfg, lp, x, a, s)
        lc.update(sst)
    else:
        x = x + a
    return _mlp_residual(cfg, lp, x, moe_impl), lc


def _cache_leaves(cfg: ModelConfig) -> Tuple[str, ...]:
    """The cache leaves stacked on L (every leaf but ``index``)."""
    return {"ssm": SSM_LEAVES, "hybrid": HYBRID_LEAVES}.get(cfg.family,
                                                           ("k", "v"))


@spmd
def prefill_chunk(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  cache: Dict[str, torch.Tensor], *,
                  impl: str = "reference", moe_impl: str = "sparse",
                  length: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the next c prompt tokens of each row against an existing
    cache (chunked prefill): tokens (B, c); ``cache["index"]`` (B,) =
    tokens already cached (the absolute position of ``tokens[:, 0]``).
    Returns (last-token logits (B, Vpad), a new cache with index += c);
    the input cache is not modified.

    ``length`` (B,) makes the call shape-stable (the engine's bucketed
    rounds): only the first ``length[b]`` tokens of row b are real, the
    logits row is the last valid token's, ``index`` advances by
    ``length``, and every cache leaf is as an unpadded call of
    ``length[b]`` tokens leaves it (bit for bit on the dense family).
    Rows with length 0 are inert (logits garbage, state untouched).
    ``impl`` is accepted for the JAX signature: neither package's chunk
    step has a kernel choice."""
    check_supported(cfg)
    B, c = tokens.shape
    start = cache["index"]
    positions = start[:, None] + torch.arange(c, device=tokens.device)
    x, _ = _embed(cfg, params, tokens, positions)
    layer_caches = []
    for l, lp in enumerate(unstack_layers(params)):
        x, lc = _block_chunk(cfg, lp, x,
                             {k: cache[k][l] for k in _cache_leaves(cfg)},
                             start, impl, moe_impl, length)
        layer_caches.append(lc)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if length is None:
        x_last, advance = x[:, -1], c
    else:
        last = torch.clamp(length - 1, min=0).long()
        x_last = torch.take_along_dim(
            x, last[:, None, None].expand(B, 1, x.shape[-1]), dim=1)[:, 0]
        advance = length
    out = _stack(layer_caches)
    out["index"] = (start + advance).to(torch.int32)
    return _logits(cfg, params, x_last), out


@spmd
def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], *, impl: str = "reference",
                moe_impl: str = "sparse"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B,) or (B, 1); one decode step.  Returns (logits (B, Vpad),
    a new cache with index + 1); the input cache is not modified.  The
    dense family's attention backend is ``impl`` ("paged", "flash_jnp";
    "seqsharded"; "reference", "flash" and any other the JAX package
    sends to its reference branch take the reference decode); RWKV6
    ignores it, as in JAX."""
    check_supported(cfg)
    if tokens.ndim == 1:
        tokens = tokens[:, None]
    index = cache["index"]
    x, _ = _embed(cfg, params, tokens, index[:, None])
    if cfg.family == "ssm":
        return _decode_rwkv(cfg, params, x, cache)
    layer_caches = []
    for l, lp in enumerate(unstack_layers(params)):
        x, lc = _block_decode(cfg, lp, x,
                              {k: cache[k][l] for k in _cache_leaves(cfg)},
                              index, impl, moe_impl)
        layer_caches.append(lc)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _logits(cfg, params, x[:, 0])
    out = {"index": index + 1}
    out.update(_stack(layer_caches))
    return logits, out


@spmd
def decode_step_deferred(cfg: ModelConfig, params: Params,
                         tokens: torch.Tensor,
                         cache: Dict[str, torch.Tensor], *,
                         impl: str = "reference", moe_impl: str = "sparse"
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step with a DEFERRED cache append (JAX's
    ``decode_step_deferred``): every layer reads the cache as it stands
    (``attention_decode_deferred``) and returns its new token's K/V, and
    ONE scatter over (L, rows, slot) writes them all after the layer loop
    instead of one cache write per layer.  Equal to ``decode_step`` up to
    the fp32 merge of the new token's softmax group.  Under a window the
    scatter writes ring slot ``index mod Smax``; a hybrid layer's new SSM
    state is its delta, stacked as it is.  RWKV6's states are the delta:
    its step is ``decode_step``'s.  Under ``impl="seqsharded"`` the
    scatter is shard-local on the sequence-sharded cache
    (``distributed.collectives.seqsharded_write``).  Returns (logits (B,
    Vpad), a new cache with index + 1); the input cache is not
    modified."""
    check_supported(cfg)
    if tokens.ndim == 1:
        tokens = tokens[:, None]
    index = cache["index"]
    x, _ = _embed(cfg, params, tokens, index[:, None])
    if cfg.family == "ssm":
        return _decode_rwkv(cfg, params, x, cache)
    deltas = []
    for l, lp in enumerate(unstack_layers(params)):
        x, delta = _block_decode(cfg, lp, x,
                                 {k: cache[k][l] for k in _cache_leaves(cfg)},
                                 index, impl, moe_impl, deferred=True)
        deltas.append(delta)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _logits(cfg, params, x[:, 0])
    deltas = _stack(deltas)
    B, Smax = tokens.shape[0], cache["k"].shape[2]
    slot = (index % Smax if cfg.window
            else torch.clamp(index, max=Smax - 1))
    if impl == "seqsharded":
        new_k = seqsharded_write(get_mesh(), cache["k"], deltas.pop("k_new"),
                                 slot)
        new_v = seqsharded_write(get_mesh(), cache["v"], deltas.pop("v_new"),
                                 slot)
    else:
        rows = torch.arange(B, device=tokens.device)
        new_k, new_v = cache["k"].clone(), cache["v"].clone()
        new_k[:, rows, slot] = deltas.pop("k_new")      # (L, B, Hkv, D)
        new_v[:, rows, slot] = deltas.pop("v_new")
    out = {"index": index + 1, "k": new_k, "v": new_v}
    out.update(deltas)                              # hybrid: h, conv
    return logits, out


def _decode_rwkv(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RWKV6 decode: the O(1) recurrence per layer (plain torch, as in
    JAX, which has no kernel there)."""
    layer_caches = []
    for l, lp in enumerate(unstack_layers(params)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, st = rwkv_mod.rwkv_time_mix_decode(
            lp, cfg, h, {k: cache[k][l] for k in SSM_LEAVES})
        x = x + y
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        cm, st["x_cm"] = rwkv_mod.rwkv_channel_mix(lp, cfg, h2, st["x_cm"])
        x = x + cm
        layer_caches.append(st)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    out = _stack(layer_caches)
    out["index"] = cache["index"] + 1
    return _logits(cfg, params, x[:, 0]), out
