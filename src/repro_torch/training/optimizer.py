"""AdamW + LR schedules on nested dicts of tensors: the port's copy of
``repro.training.optimizer``.

Optimizer state is fp32 (master weights + moments) regardless of the
bf16 compute params.  Every function is functional: it returns new
tensors and modifies none of its inputs, so a step can be re-run after a
failure (``distributed.run_with_retries``).  The step-dependent scalars
(learning rate, bias corrections, clip scale) are 0-dim fp32 tensors on
the params' device, computed in fp32 as JAX computes them, and never
leave the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, Any]


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32
    master: Tree                 # fp32 params
    mu: Tree                     # fp32 first moment
    nu: Tree                     # fp32 second moment


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # cosine | linear | constant
    min_lr_ratio: float = 0.1


def tree_map(fn, *trees: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, *(t[k] for t in trees))
            if isinstance(trees[0][k], dict) else fn(*(t[k] for t in trees))
            for k in trees[0]}


def tree_leaves(tree: Tree):
    """Leaves in sorted-key order (``jax.tree.leaves``'s order)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from tree_leaves(tree[k])
        else:
            yield tree[k]


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1 - t)
    else:
        decay = torch.ones_like(t)
    return cfg.lr * warm * decay


def init_adamw(params: Tree) -> AdamWState:
    """Every leaf owns a DISTINCT fp32 buffer (a copy even where the param
    is already fp32), so no state leaf aliases a param."""
    step = next(tree_leaves(params)).new_zeros((), dtype=torch.int32)
    return AdamWState(
        step=step,
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def global_norm(tree: Tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree))
    return torch.sqrt(sq)


def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree) -> Tuple[Tree, AdamWState, dict]:
    """Returns (new params in the params' dtypes, new state, metrics);
    the inputs are not modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(g, m, mu, nu):
        g = g.float() * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mhat = mu / bc1
        nhat = nu / bc2
        m = m - lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                      + cfg.weight_decay * m)
        return m, mu, nu

    new = tree_map(lambda g, m, mu, nu: upd(g, m, mu, nu), grads,
                   state.master, state.mu, state.nu)
    master = tree_map(lambda n: n[0], new)
    mu = tree_map(lambda n: n[1], new)
    nu = tree_map(lambda n: n[2], new)
    new_params = tree_map(lambda m, p: m.to(p.dtype, copy=True), master,
                          params)          # never an alias of the state
    new_state = AdamWState(step=step, master=master, mu=mu, nu=nu)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
