#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one NVIDIA card.

    python3 scripts/profile_port_train.py [--report PATH] [--arch A]
        [--layers N] [any other argument of launch/train.py]

Trains the smoke run of ``repro_torch.launch.train`` (``SMOKE_ARGS``:
full-width SmolLM-360M, bf16 params, fp32 AdamW, B=8, S=512, remat), or
that run with the trainer arguments given here in place of the smoke
run's (``--arch hymba-1.5b --batch 4``, ``--arch qwen2-moe-a2.7b
--layers 2``), through the trainer's own step: 2 warm-up steps, then 4 steps timed with
a device sync after each, then 3 steps under ``torch.profiler`` (CPU +
CUDA activities) for the kernel count and the device time by kernel
name.  The device's busy share is that device time per step over the
timed steps' mean wall.  The step's two halves are then timed alone with
CUDA events on the same inputs: the loss and its gradients, and the
AdamW update.  Also times the host's cost of enqueuing one
tiny eager op.  Prints a table of the top kernels and one JSON summary
line; ``--report`` writes the summary as a file.  Exits 1 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WARM, TIMED, ACTIVE = 2, 4, 3      # steps: warm-up, timed, profiled


def step_halves_ms(torch, targs, cfg, params, state, batch, iters=3):
    """(ms of ``value_and_grad`` of the loss, ms of ``adamw_update``),
    each the mean of ``iters`` calls after one warm-up, from CUDA events."""
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      make_loss_fn, value_and_grad)
    grad_fn = value_and_grad(make_loss_fn(cfg))
    opt_cfg = AdamWConfig(lr=targs.lr, total_steps=targs.steps,
                          warmup_steps=max(1, targs.steps // 20))
    _, grads = grad_fn(params, batch)

    def ms(fn):
        fn()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    return (ms(lambda: grad_fn(params, batch)),
            ms(lambda: adamw_update(opt_cfg, grads, state, params)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report")
    args, train_argv = ap.parse_known_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_port_train: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from profile_port_serve import host_us_per_tiny_op, kernel_summary, \
        top_kernels
    from repro_torch.launch import train as T
    from torch.profiler import ProfilerActivity, profile

    targs = T.parse_args(T.SMOKE_ARGS + train_argv + ["--device", "cuda"])
    cfg, params, state, step_fn, dcfg = T.build(targs)
    out = {"card": torch.cuda.get_device_name(0), "arch": cfg.name,
           "layers": cfg.num_layers, "batch": targs.batch, "seq": targs.seq,
           "host_us_per_tiny_op": host_us_per_tiny_op(torch)}
    step = 0

    def run(n):
        nonlocal params, state, step
        walls = []
        for _ in range(n):
            batch = T.batch_at(cfg, dcfg, step, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, _ = step_fn(params, state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            step += 1
        return walls

    run(WARM)
    walls = run(TIMED)
    wall_s = sum(walls) / len(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(ACTIVE)
    by_kernel, launches = kernel_summary(prof)
    grad_ms, adamw_ms = step_halves_ms(torch, targs, cfg, params, state,
                                       T.batch_at(cfg, dcfg, step, "cuda"))
    n_kernels = sum(c for c, _ in by_kernel.values())
    device_s = sum(t for _, t in by_kernel.values()) / 1e6 / ACTIVE
    out.update(step_walls_s=walls, wall_ms_per_step=wall_s * 1e3,
               tokens_per_s=targs.batch * targs.seq / wall_s,
               kernels_per_step=n_kernels / ACTIVE,
               launch_calls_per_step=launches / ACTIVE,
               device_ms_per_step=device_s * 1e3,
               device_busy_share=device_s / wall_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss_and_grad_ms=grad_ms, adamw_ms=adamw_ms,
               top_kernels=top_kernels(by_kernel))
    print(f"{out['card']}: {cfg.name} ({cfg.num_layers} layers) train "
          f"step B={targs.batch} "
          f"S={targs.seq}: {out['wall_ms_per_step']:.1f} ms "
          f"({out['tokens_per_s']:.0f} tokens/s; walls "
          f"{[round(w, 4) for w in walls]}); host enqueue of a tiny op "
          f"{out['host_us_per_tiny_op']:.1f} us")
    print(f"profiled {ACTIVE} steps: {out['kernels_per_step']:.0f} kernels "
          f"and {out['launch_calls_per_step']:.0f} launch calls per step, "
          f"device busy {out['device_ms_per_step']:.2f} ms/step = "
          f"{out['device_busy_share']:.1%} of the unprofiled step wall; "
          f"peak memory {out['peak_mem_gb']:.2f} GB")
    print(f"alone: loss and gradients {grad_ms:.2f} ms, AdamW update "
          f"{adamw_ms:.2f} ms (CUDA events)")
    for k in out["top_kernels"]:
        print(f"  {k['ms']:10.2f} ms  {k['count']:7d}  {k['name']}")
    print(json.dumps(out))
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
