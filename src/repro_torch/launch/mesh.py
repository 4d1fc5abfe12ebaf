"""Device meshes and the ranks behind them: ``repro.launch.mesh`` on
``torch.distributed``.

Mesh builders are FUNCTIONS, not module-level constants: importing this
module touches no device and no process group.  A mesh needs a started
process group (``init_rank``, or ``run_ranks``, which starts one per
rank); its axes are ``("data", "model")``, or ``("pod", "data",
"model")`` multi-pod.

The backend follows the devices (``backend_for``): ``nccl`` when every
rank has a card of its own, ``gloo`` when ranks share one card (NCCL
refuses two ranks on one device) or run on the CPU.  A rank counts the
ranks of its own host: ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` where a
multi-host launcher sets them (``torchrun`` does), else every rank is
on this host (``run_ranks``).  ``gloo`` crashes
on the functional all-gather of CUDA tensors; ``distributed.context``
stages that one through pinned host memory and counts it.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.context import stage_cuda_all_gather


def backend_for(device: str, local_world: int) -> str:
    """``nccl`` when ``local_world`` ranks each get a card of their own,
    else ``gloo``."""
    if device == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _make_mesh(shape: Sequence[int], axes: Sequence[str], device: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"``:
    256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 2, *, device: str = "cuda"):
    """Small mesh over the first ``data * model`` ranks' world."""
    return _make_mesh((data, model), ("data", "model"), device)


def init_rank(rank: int, world: int, store_path: str, *,
              device: str = "cuda", timeout_s: float = 120.0) -> str:
    """Start this process's rank of a ``world``-rank group from a
    ``FileStore`` at ``store_path`` (no port to collide on), with
    ``timeout_s`` for every collective; returns the backend.  CUDA ranks
    take card ``local rank % device_count`` (module docstring)."""
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = backend_for(device, local_world)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "gloo" and device == "cuda":
        stage_cuda_all_gather()
    return backend


def _rank_main(fn, rank, world, store_path, device, timeout_s, args,
               results):
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        init_rank(rank, world, store_path, device=device,
                  timeout_s=timeout_s)
        if device == "cpu":
            torch.set_num_threads(1)
        out = fn(rank, world, *args)
        dist.barrier()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args: Any, device: str = "cuda",
              timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, one
    rank each of a fresh process group on ``device``; returns the ranks'
    results in rank order.  ``fn`` must be importable (a module-level
    function).  Raises ``RuntimeError`` with the first failing rank's
    traceback if a rank fails, and kills every rank after ``timeout_s``
    (also each collective's timeout): a hung rank fails its caller
    instead of holding it.  All ranks run on this host."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, store, device, timeout_s,
                                   args, results)) for r in range(world)]
        for p in procs:
            p.start()
        done, deadline, error = {}, time.monotonic() + timeout_s, None
        try:
            while len(done) < world and error is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    error = f"ranks timed out after {timeout_s} s"
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        error = f"a rank exited with code {dead[0]}"
                    continue
                if ok:
                    done[rank] = pickle.loads(payload)
                else:
                    error = f"rank {rank} failed:\n{payload}"
        finally:
            for p in procs:
                p.join(timeout=10 if error is None else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if error is not None:
        raise RuntimeError(error)
    return [done[r] for r in range(world)]
