"""Training example on the PyTorch port: the sharded train step on a
small mesh of ranks — DTensor params on a (2, 2) ``("data", "model")``
mesh, gradient accumulation, deterministic data, a checkpoint and a
resume.  The ranks are processes started by ``launch.mesh.run_ranks``
(``gloo`` where they share a card or run on the CPU, ``nccl`` where each
has a card of its own).

Run:  PYTHONPATH=src python examples/torch_train_multipod.py
      [--device cuda|cpu] [--steps 30]
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, "src")

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.distributed.context import P, to_dtensor
from repro_torch.distributed.fault_tolerance import reshard
from repro_torch.distributed.sharding import fit_specs, param_pspecs
from repro_torch.launch.mesh import make_test_mesh, run_ranks
from repro_torch.models import model as M
from repro_torch.training import AdamWConfig, init_adamw, make_train_step
from repro_torch.training.optimizer import AdamWState, tree_map


def _whole(t):
    """A DTensor's global value (a collective: every rank calls it)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def train_rank(rank, world, device, steps, ckpt_dir):
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              dtype="float32")
    mesh = make_test_mesh(2, 2, device=device)
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    params = M.init_params(cfg, seed=0, device=dev)
    # reduced dims aren't all divisible by the toy mesh: replicate them
    specs = fit_specs(param_pspecs(cfg, params, fsdp=False), params, mesh)

    def whole(p, state: AdamWState):
        """Params and optimizer state as global values (collectives)."""
        return {"p": tree_map(_whole, p), "step": _whole(state.step),
                **{k: tree_map(_whole, getattr(state, k))
                   for k in ("master", "mu", "nu")}}

    def place(w):
        """``whole``'s global values placed on the mesh again."""
        return reshard(w["p"], mesh, specs), AdamWState(
            step=w["step"], **{k: reshard(w[k], mesh, specs)
                               for k in ("master", "mu", "nu")})

    params = reshard(params, mesh, specs)
    opt_state = init_adamw(params)
    step_fn = make_train_step(
        cfg, AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=2),
        microbatches=2)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)

    def batch(step):
        return {k: to_dtensor(torch.from_numpy(v).to(dev, torch.long),
                              mesh, P("data", None))
                for k, v in batch_for_step(dc, step).items()}

    mgr = CheckpointManager(ckpt_dir, interval=10, keep=2,
                            async_write=False)
    first, log = steps * 2 // 3, []
    for step in range(first):
        params, opt_state, m = step_fn(params, opt_state, batch(step))
        loss = float(_whole(m["loss"]))
        if step % 5 == 0 and rank == 0:
            print(f"step {step:3d}  loss {loss:.4f}  "
                  f"lr {float(_whole(m['lr'])):.2e}", flush=True)
        # the checkpoint holds global values: every rank gathers, rank 0
        # writes
        if (step + 1) % mgr.interval == 0:
            state = whole(params, opt_state)
            if rank == 0:
                mgr.save(state, step + 1, block=True)
            torch.distributed.barrier()
    # a restart: every rank restores the global values and places them
    restored, at = mgr.restore_latest(whole(params, opt_state))
    params, opt_state = place(restored)
    if rank == 0:
        print(f"restored checkpoint at step {at}; continuing to {steps}",
              flush=True)
    for step in range(at, steps):
        params, opt_state, m = step_fn(params, opt_state, batch(step))
        log.append(float(_whole(m["loss"])))
    return log[-1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        losses = run_ranks(train_rank, 4, args.device, args.steps, ckpt_dir,
                           device=args.device, timeout_s=1800)
    assert len(set(losses)) == 1, losses     # every rank, one loss
    print(f"final loss {losses[0]:.4f} on every rank; the SAME "
          "make_train_step is what launch/dryrun.py runs on the 512-rank "
          "production mesh")


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
