"""Logical sharding rules for every architecture family:
``repro.distributed.sharding`` for the port.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Megatron-style tensor parallelism on ``model`` (all feature
dims of the assigned archs are divisible by 16 — verified in tests),
FSDP over ``data`` for training, replication over ``data`` for serving.

MoE expert tensors are expert-parallel over ``model`` (E padded to a
multiple of 16).  KV caches are batch-sharded over (pod, data) and
sequence-sharded over ``model``.

The rules are JAX's, entry for entry, and produce the port's
``PartitionSpec`` (``distributed.context.P``) for the same trees;
``named`` turns a spec tree into DTensor placements, and
``fault_tolerance.reshard`` places a tree under one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.context import (P, axis_size, dp_axes_of,
                                             placements)

# weights whose LAST dim is TP-sharded (column parallel)
_COL = ("wq", "wk", "wv", "wi_gate", "wi_up", "cm_k", "cm_r", "in_proj",
        "router")
# weights whose MIDDLE (input) dim is TP-sharded (row parallel)
_ROW = ("wo", "out_proj", "cm_v")
# SSM per-channel tensors sharded on the channel (d_inner) dim
_SSM_CHANNEL = ("dt_proj", "bc_proj", "A_log", "dt_bias", "D", "conv_w")
# expert-parallel stacked tensors (L, E, ...)
_EXPERT = ("wi_gate", "wi_up", "wo")


def _param_rule(path: Tuple[str, ...], ndim: int, *, fsdp: bool) -> P:
    name = path[-1]
    data = "data" if fsdp else None
    in_layers = "layers" in path
    in_moe = "moe" in path and "shared" not in path

    if name in ("embed", "head"):
        return P("model", None)
    if name == "patch_proj":
        return P(None, "model")
    if not in_layers:
        return P()  # ln_f etc.

    # ---- stacked per-layer tensors: leading L axis is never sharded ----
    if in_moe:
        if name in _EXPERT and ndim == 4:          # (L, E, d, ff)/(L, E, ff, d)
            return P(None, "model", data, None)
        if name == "router":                        # (L, d, E)
            return P(None, data, "model")
        return P()                                   # shared_gate etc.
    if name in _ROW and ndim == 3:
        return P(None, "model", data)
    if name in _COL and ndim == 3:
        return P(None, data, "model")
    if name == "wg" and ndim == 3:                   # rwkv gate proj
        return P(None, data, "model")
    if name in ("wr", "wk", "wv") and ndim == 3:     # rwkv projections
        return P(None, data, "model")
    if name in _SSM_CHANNEL:
        if name == "dt_proj":                        # (L, di, di)
            return P(None, "model", None)
        if name == "bc_proj":                        # (L, di, 2N)
            return P(None, "model", None)
        if name == "A_log":                          # (L, di, N)
            return P(None, "model", None)
        if name == "conv_w":                         # (L, K, di)
            return P(None, None, "model")
        return P(None, "model")                      # (L, di)
    if name == "decay_lora_a" and ndim == 3:         # (L, d, R)
        return P(None, data, None)
    if name == "decay_lora_b" and ndim == 3:         # (L, R, d)
        return P(None, None, data)
    return P()                                        # norms, mus, biases


def _path_names(path) -> Tuple[str, ...]:
    """A key path as names: the port's trees are nested dicts, so a path
    is already a tuple of keys."""
    return tuple(str(p) for p in path)


def _map_with_path(fn, tree, path=()):
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def param_pspecs(cfg: ModelConfig, params_shape: Any, *,
                 fsdp: bool = False) -> Any:
    """PartitionSpec tree matching ``init_params``' structure.

    params_shape: shape-only params (``serving.serve_step.param_specs``)
    or real params.
    """
    def rule(path, leaf):
        return _param_rule(_path_names(path), len(leaf.shape), fsdp=fsdp)

    return _map_with_path(rule, params_shape)


# --------------------------------------------------------------------- #
# batch / cache shardings
# --------------------------------------------------------------------- #


#: the data-parallel axes of a mesh (JAX's name in this module)
dp_axes = dp_axes_of


def _dp(mesh, size: int) -> Optional[Tuple[str, ...]]:
    """Data-parallel axes usable for a batch of ``size`` (None if < mesh)."""
    axes = dp_axes(mesh)
    total = 1
    for a in axes:
        total *= axis_size(mesh, a)
    if size % total == 0:
        return axes
    if "data" in axes and size % axis_size(mesh, "data") == 0:
        return ("data",)
    return None


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 *, seq_shard: bool = True) -> Dict[str, Any]:
    """PartitionSpecs for the cell's inputs (mirrors serve_input_specs)."""
    B = shape.global_batch
    dp = _dp(mesh, B)
    bspec = P(dp) if dp else P(None)
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {"tokens": P(dp, None)}
        if shape.kind == "train":
            specs["labels"] = P(dp, None)
        if cfg.frontend == "patch":
            specs["patch_embeds"] = P(dp, None, None)
        return specs
    # decode: {tokens (B,), cache}
    seq = "model" if seq_shard else None

    def cache_rule(path, leaf):
        name = _path_names(path)[-1]
        nd = len(leaf.shape)
        if name == "index":
            return bspec
        if name in ("k", "v"):              # (L, B, S, Hkv, D)
            S = leaf.shape[2]
            s_ok = seq and S % axis_size(mesh, "model") == 0
            return P(None, dp, seq if s_ok else None, None, None)
        if name == "h":                      # (L, B, di, N)
            return P(None, dp, "model", None)
        if name == "conv":                   # (L, B, K-1, di)
            return P(None, dp, None, "model")
        if name == "S":                      # (L, B, H, D, D)
            H = leaf.shape[2]
            hs = "model" if H % axis_size(mesh, "model") == 0 else None
            return P(None, dp, hs, None, None)
        if name in ("x_tm", "x_cm"):         # (L, B, 1, d)
            return P(None, dp, None, "model")
        return P(None, dp) if nd >= 2 else bspec

    from repro_torch.serving.serve_step import cache_specs
    cache_shape = cache_specs(cfg, B, shape.seq_len)
    cache_spec = _map_with_path(cache_rule, cache_shape)
    return {"tokens": bspec, "cache": cache_spec}


def out_pspecs_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      *, seq_shard: bool = True) -> Any:
    """(logits, cache) output specs for the decode serve_step."""
    cs = batch_pspecs(cfg, shape, mesh, seq_shard=seq_shard)
    B = shape.global_batch
    dp = _dp(mesh, B)
    logits = P(dp, "model")
    return (logits, cs["cache"])


def fit_specs(specs: Any, tree: Any, mesh) -> Any:
    """``specs`` with ``P()`` for every leaf of ``tree`` whose sharded
    dimension does not divide its mesh axes: such leaves are replicated,
    as JAX's sharded train step test places them
    (``tests/test_distributed.py``)."""
    def fit(spec, leaf):
        for d, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(axis_size(mesh, a) for a in names if a is not None)
            if leaf.shape[d] % n:
                return P()
        return spec
    return {k: fit_specs(specs[k], v, mesh) if isinstance(v, dict)
            else fit(specs[k], v) for k, v in tree.items()}


def named(mesh, spec_tree: Any) -> Any:
    """The DTensor placements over ``mesh`` of every spec in the tree."""
    if isinstance(spec_tree, P):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return type(spec_tree)(named(mesh, s) for s in spec_tree)
