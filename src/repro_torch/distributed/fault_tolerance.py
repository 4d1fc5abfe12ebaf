"""Fault-tolerance primitives of the port: the pure-Python part of
``repro.distributed.fault_tolerance``.

* ``run_with_retries`` — transient-error shield around a step function
  (a failed CUDA launch or step surfaces as ``RuntimeError``); the
  serving engine retries transient swap-store writes through it on a
  virtual backoff clock.
* ``StragglerMonitor`` — per-batch deadline relative to the cost model's
  prediction; the serving engine requeues a flagged batch's requests
  (``EngineConfig.straggler_factor``), the training loop logs slow steps
  and continues (the deterministic data pipeline lets any host recompute
  any shard).

``elastic_remesh`` and ``reshard`` are mesh tools and wait for the
distributed layer (ROADMAP A13).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

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
