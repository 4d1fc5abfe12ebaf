"""Fault tolerance & elasticity primitives:
``repro.distributed.fault_tolerance`` for the port.

* ``run_with_retries`` — transient-error shield around a step function
  (a failed CUDA launch or step surfaces as ``RuntimeError``); the
  serving engine retries transient swap-store writes through it on a
  virtual backoff clock.
* ``StragglerMonitor`` — per-batch deadline relative to the cost model's
  prediction; the serving engine requeues a flagged batch's requests
  (``EngineConfig.straggler_factor``), the training loop logs slow steps
  and continues (the deterministic data pipeline lets any host recompute
  any shard).

* ``elastic_remesh`` — rebuild a mesh on a SHRUNKEN set of ranks after
  node loss, keeping the model axis intact, and ``reshard`` any tree of
  tensors onto the new mesh under partition specs.  The "devices" of
  the JAX function are the surviving ranks here: the new mesh takes the
  first ranks that fit, and ranks left out of it wait at a barrier.
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.context import to_dtensor

log = logging.getLogger("repro_torch.ft")


def run_with_retries(fn: Callable, *args, retries: int = 3,
                     backoff_s: float = 0.1,
                     retry_on: Tuple = (RuntimeError,),
                     sleep: Optional[Callable[[float], None]] = None, **kw):
    """Re-execute ``fn`` on transient runtime errors (safe for the port's
    functional steps, which never modify their inputs).

    ``sleep`` is the backoff clock — defaults to ``time.sleep``; a test
    can inject a clock that *records* the schedule (exponential:
    ``backoff_s * 2**attempt``) instead of stalling.
    """
    if sleep is None:
        sleep = time.sleep
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kw)
        except retry_on as e:
            if attempt == retries:
                raise
            log.warning("step failed (%s); retry %d/%d", e, attempt + 1,
                        retries)
            sleep(backoff_s * (2 ** attempt))


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def elastic_remesh(devices: Sequence[int], *, model_parallel: int,
                   multi_pod: bool = False, device: str = "cuda"):
    """Build the biggest valid mesh from the surviving ranks ``devices``.

    The ``model`` axis is preserved (TP degree is baked into the weight
    layout); data (and pod) shrink to the largest power of two that fits.
    Every rank of the process group calls it (building a mesh's groups
    is collective).  A rank of the new mesh gets the mesh; any other
    rank waits at a barrier of the whole group, which the mesh's ranks
    reach with ``dist.barrier()`` when they are done with it, and then
    gets ``None``.
    """
    n = len(devices)
    if n < model_parallel:
        raise ValueError(
            f"cannot keep model={model_parallel} with {n} devices")
    usable_dp = largest_pow2_leq(n // model_parallel)
    if multi_pod and usable_dp >= 2:
        pods = 2
        dp = usable_dp // 2
        shape, axes = (pods, dp, model_parallel), ("pod", "data", "model")
    else:
        shape, axes = (usable_dp, model_parallel), ("data", "model")
    total = math.prod(shape)
    ranks = list(devices)[:total]
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(device, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)
    if dist.get_rank() not in ranks:
        dist.barrier()
        return None
    return mesh


def reshard(tree: Any, mesh, pspecs: Any) -> Any:
    """Place a tree of tensors on ``mesh`` under ``pspecs`` (post-remesh):
    a plain tensor is the global value and each rank keeps its slice; a
    DTensor on ``mesh`` is redistributed."""
    if isinstance(tree, dict):
        return {k: reshard(v, mesh, pspecs[k]) for k, v in tree.items()}
    return to_dtensor(tree, mesh, pspecs)


@dataclass
class StragglerEvent:
    batch_index: int
    predicted_s: float
    actual_s: float


@dataclass
class StragglerMonitor:
    """Flags batches slower than deadline_factor x the cost-model
    prediction."""

    deadline_factor: float = 3.0
    min_floor_s: float = 1e-4
    events: List[StragglerEvent] = field(default_factory=list)
    _index: int = 0

    def observe(self, predicted_s: float, actual_s: float) -> bool:
        self._index += 1
        deadline = max(predicted_s * self.deadline_factor, self.min_floor_s)
        if actual_s > deadline:
            self.events.append(StragglerEvent(self._index, predicted_s,
                                              actual_s))
            return True
        return False
