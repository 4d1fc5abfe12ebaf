"""Training launcher: ``python -m repro_torch.launch.train --arch smollm-360m``.

The reduced config by default; ``--full`` trains the published widths
(SmolLM-360M: 32 layers, d=960, 15 query heads over 5 kv heads).  Every
family trains: ``--arch paligemma-3b`` with its stub patch embeddings in
front of the text, ``--arch musicgen-medium`` over codec tokens with
sinusoidal positions, the MoE family on the sparse dispatch (JAX's
trainer's), hymba through the SSM scan's autograd function and RWKV6
through the closed chunked form of its time-mix.  Runs
on ``--device cuda`` (the default) or ``--device cpu``.  Exercised end
to end: bf16 compute params with fp32 AdamW state, microbatched grad
accumulation, per-layer remat, the deterministic data pipeline, periodic
async checkpointing with auto-resume, straggler logging against the
H100 cost model, and retry-on-transient-failure.  The attention is the
reference branch, differentiated by autograd, as in the JAX trainer: the
flash-attention kernel is forward-only in both packages.
"""
from __future__ import annotations

import argparse
import logging
import time
from dataclasses import replace
from typing import Dict, List

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.cost_model import (BatchSpec, TheoreticalCostModel,
                                         get_hardware)
from repro_torch.data import DataConfig, batch_with_frontend
from repro_torch.distributed import StragglerMonitor, run_with_retries
from repro_torch.models import model as M
from repro_torch.training import AdamWConfig, init_adamw, make_train_step

log = logging.getLogger("repro_torch.train")

#: the card's smoke run (``chip_smoke.py``, ``scripts/profile_port_train.py``):
#: a few bf16 steps of full-width SmolLM-360M at B=8, S=512
SMOKE_ARGS = ["--full", "--arch", "smollm-360m", "--steps", "6",
              "--batch", "8", "--seq", "512", "--lr", "1e-3"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config — real-hardware scale")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep only the first N layers (0: all)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(cfg, params, opt_state, step_fn, data config) of a fresh run."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.layers:
        cfg = replace(cfg, num_layers=args.layers)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    params = M.init_params(cfg, seed=0, device=args.device)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    return cfg, params, init_adamw(params), step_fn, dcfg


def batch_at(cfg, dcfg: DataConfig, step: int, device: str
             ) -> Dict[str, torch.Tensor]:
    """The step's synthetic batch on ``device``: the token leaves
    (``tokens``, ``labels``) as int64, a ``patch`` model's float32
    ``patch_embeds`` as they are."""
    return {k: torch.from_numpy(v).to(device, torch.long
                                      if v.dtype.kind in "iu" else None)
            for k, v in batch_with_frontend(cfg, dcfg, step).items()}


def train(args: argparse.Namespace) -> List[Dict[str, float]]:
    """Run the training loop; returns one record per step taken (loss,
    grad_norm, lr, wall seconds of the step, device synchronised)."""
    cfg, params, opt_state, step_fn, dcfg = build(args)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
        if args.resume and mgr.has_checkpoint():
            state, start_step = mgr.restore_latest(
                {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            log.info("resumed from step %d", start_step)

    cm = TheoreticalCostModel(cfg, get_hardware("h100"))
    straggler = StragglerMonitor(deadline_factor=10.0, min_floor_s=1.0)
    history: List[Dict[str, float]] = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = batch_at(cfg, dcfg, step, args.device)
        t0 = time.time()
        params, opt_state, metrics = run_with_retries(
            step_fn, params, opt_state, batch)
        rec = {k: float(v) for k, v in metrics.items()}   # waits for it
        rec["seconds"] = time.time() - t0
        history.append(rec)
        if straggler.observe(
                cm.batch_time(BatchSpec(prefills=[(args.seq, 0)] * args.batch)),
                rec["seconds"]):
            log.warning("straggler batch at step %d", step)
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %d loss %.4f grad_norm %.3f lr %.2e",
                     step, rec["loss"], rec["grad_norm"], rec["lr"])
        if mgr is not None:
            mgr.maybe_save({"params": params, "opt": opt_state}, step + 1)
    if mgr is not None:
        mgr.save({"params": params, "opt": opt_state}, args.steps,
                 block=True)
    log.info("done: %d steps in %.1fs", args.steps - start_step,
             time.time() - t_start)
    return history


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    train(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
