"""Train-step builder: microbatched grad accumulation + remat + AdamW
(``repro.training.train_step`` for the port).

``make_train_step(cfg, opt_cfg, microbatches=k)`` returns a FUNCTIONAL
``(params, opt_state, batch) -> (params, opt_state, metrics)``: it
returns new params and state and modifies neither input (gradients come
from ``torch.autograd.grad`` on detached leaves; nothing writes a
``.grad`` or updates in place), so ``run_with_retries`` can re-run it
after a failure from the same inputs.  The global batch is split into k
microbatches run in turn (activation memory / k); gradients accumulate
in fp32.  Metrics are 0-dim device tensors: reading one waits for the
device.

The step runs on DTensor params too (placed by ``distributed.sharding.
param_pspecs`` with ``fault_tolerance.reshard``) and a DTensor batch
sharded over ``data``: the counterpart of ``jax.jit`` of the same step
under a mesh (GSPMD).  It runs under ``distributed.context.spmd_scope``,
so the optimizer's step count, learning rate and clip scale, plain
tensors, meet the DTensor leaves as replicated values; the params stay
DTensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import placed_like, spmd
from repro_torch.models import model as M
from repro_torch.training.optimizer import (AdamWConfig, AdamWState, Tree,
                                            adamw_update, tree_leaves,
                                            tree_map)


def make_loss_fn(cfg: ModelConfig, *, impl: str = "reference",
                 moe_impl: str = "sparse", remat: bool = True) -> Callable:
    def loss_fn(params, batch):
        return M.train_loss(cfg, params, batch, impl=impl,
                            moe_impl=moe_impl, remat=remat)
    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad`` for a loss of a dict of tensors: (params,
    batch) -> (loss, grads in the params' structure, dtypes and, for
    DTensor params, placements: a gradient summed over data-parallel
    ranks is reduced, as GSPMD reduces it).  The params are not
    modified."""
    @spmd
    def fn(params: Tree, batch) -> Tuple[torch.Tensor, Tree]:
        leaf = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = list(tree_leaves(leaf))
        with torch.enable_grad():
            loss = loss_fn(leaf, batch)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(placed_like(g, p) for g, p in zip(grads, leaves))
        return loss.detach(), _unflatten(leaf, it)
    return fn


def _unflatten(tree: Tree, it) -> Tree:
    """Rebuild ``tree``'s structure from leaves in sorted-key order."""
    return {k: _unflatten(tree[k], it) if isinstance(tree[k], dict)
            else next(it) for k in sorted(tree)}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, impl: str = "reference",
                    moe_impl: str = "sparse", remat: bool = True) -> Callable:
    grad_fn = value_and_grad(make_loss_fn(cfg, impl=impl, moe_impl=moe_impl,
                                          remat=remat))

    @spmd
    def train_step(params: Tree, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Tree, AdamWState, Dict]:
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            loss_sum = None
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, g = grad_fn(params, mb)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss_sum = loss if loss_sum is None else loss_sum + loss
            loss = loss_sum / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        else:
            loss, grads = grad_fn(params, batch)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
