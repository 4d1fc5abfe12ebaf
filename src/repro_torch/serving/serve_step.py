"""Serve- and train-step builders: ``repro.serving.serve_step`` for the
port.

``build_prefill_fn`` / ``build_decode_fn`` / ``build_train_fn`` return
plain functions of (params, batch/cache) over ``models.model``; PyTorch
runs them eagerly, so there is nothing to compile.  ``param_specs`` and
``cache_specs`` are the shape-only trees of ``jax.eval_shape``: the
model's own init run on fake tensors, which allocate nothing (the
sharding rules read their shapes).
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def param_specs(cfg: ModelConfig) -> Any:
    """The params tree of ``cfg`` as fake tensors (shapes and dtypes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return M.init_params(cfg, device="cpu")


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Any:
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return M.init_cache(cfg, batch, cache_len, device="cpu")


def build_prefill_fn(cfg: ModelConfig, *, cache_len: int,
                     impl: str = "reference",
                     moe_impl: str = "sparse") -> Callable:
    """(params, batch) -> (last-token logits, KV cache)."""

    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, cache_len=cache_len, impl=impl,
                         moe_impl=moe_impl)

    return prefill_step


def build_prefill_chunk_fn(cfg: ModelConfig, *, impl: str = "reference",
                           moe_impl: str = "sparse") -> Callable:
    """(params, tokens (B, bucket), cache, lengths (B,)) -> (logits, cache).

    The shape-stable bucketed chunk step of the engine's slot-resident
    (batched) plane, for the dense family and RWKV6: tokens are padded to
    a fixed bucket length and ``lengths`` marks each row's real prefix
    (0 = inert row)."""
    M.check_supported(cfg)

    def chunk_step(params, tokens, cache, lengths):
        return M.prefill_chunk(cfg, params, tokens, cache, impl=impl,
                               moe_impl=moe_impl, length=lengths)

    return chunk_step


def build_decode_fn(cfg: ModelConfig, *, impl: str = "reference",
                    moe_impl: str = "sparse",
                    append: str = "inline") -> Callable:
    """(params, tokens, cache) -> (logits, cache): one serve step;
    ``append="deferred"`` writes the step's new K/V with one scatter
    after the layer loop (``models.model.decode_step_deferred``)."""
    if append not in ("inline", "deferred"):
        raise ValueError(f"unknown decode append {append!r}")
    step = M.decode_step_deferred if append == "deferred" else M.decode_step

    def serve_step(params, tokens, cache):
        return step(cfg, params, tokens, cache, impl=impl,
                    moe_impl=moe_impl)

    return serve_step


def build_train_fn(cfg: ModelConfig, *, impl: str = "reference",
                   moe_impl: str = "sparse", remat: bool = True) -> Callable:
    """(params, batch) -> scalar loss (the differentiable objective)."""

    def loss_fn(params, batch):
        return M.train_loss(cfg, params, batch, impl=impl,
                            moe_impl=moe_impl, remat=remat)

    return loss_fn
