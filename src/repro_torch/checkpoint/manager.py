"""Checkpoint manager: periodic async saves, retention, auto-resume,
SIGTERM drain (the port's copy of ``repro.checkpoint.manager``).

The async writer snapshots the state to host memory synchronously (cheap)
and writes to disk on a worker thread, so the training loop never blocks
on I/O.  ``install_sigterm_drain`` arranges a final synchronous save when
the scheduler/cluster preempts the job.
"""
from __future__ import annotations

import logging
import signal
import threading
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.checkpoint import store

log = logging.getLogger("repro_torch.ckpt")


def _snapshot(state: Any) -> Any:
    """A host copy of every tensor leaf (a copy even of CPU tensors, so
    the writer thread never reads a buffer the caller may reuse)."""
    leaves = {name: (leaf.detach().to("cpu", copy=True)
                     if isinstance(leaf, torch.Tensor) else leaf)
              for name, leaf in store.flatten_with_names(state)}
    return store.unflatten_like(state, leaves)


class CheckpointManager:
    def __init__(self, directory: str, *, interval: int = 100,
                 keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._last_saved_step = -1
        self._lock = threading.Lock()
        # test hook: raise inside the writer to exercise failure paths
        self.failure_injection: Optional[Callable[[int], None]] = None

    # ------------------------------------------------------------------ #
    def should_save(self, step: int) -> bool:
        return step % self.interval == 0 and step != self._last_saved_step

    def _write(self, host_tree: Any, step: int) -> None:
        if self.failure_injection is not None:
            self.failure_injection(step)
        store.save(host_tree, self.directory, step)
        store.retain(self.directory, self.keep)
        log.info("checkpoint step %d committed", step)

    def save(self, state: Any, step: int, *, block: bool = False) -> None:
        """Snapshot to host memory now; write async (or sync)."""
        host_tree = _snapshot(state)                 # device->host snapshot
        with self._lock:
            self.wait()
            self._last_saved_step = step
            if self.async_write and not block:
                self._thread = threading.Thread(
                    target=self._safe_write, args=(host_tree, step),
                    daemon=True)
                self._thread.start()
            else:
                self._write(host_tree, step)

    def _safe_write(self, host_tree: Any, step: int) -> None:
        try:
            self._write(host_tree, step)
        except Exception:  # pragma: no cover
            log.exception("async checkpoint write failed at step %d", step)

    def maybe_save(self, state: Any, step: int) -> bool:
        if self.should_save(step):
            self.save(state, step)
            return True
        return False

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    # ------------------------------------------------------------------ #
    def restore_latest(self, template: Any) -> Tuple[Any, int]:
        """Latest VALID checkpoint (hash-verified; torn writes skipped),
        each leaf on its template leaf's device."""
        steps = store.list_steps(self.directory)
        for step in reversed(steps):
            path = f"{self.directory}/step_{step:09d}"
            if store.verify(path):
                return store.restore(template, self.directory, step)
            log.warning("checkpoint %s failed verification; skipping", path)
        raise FileNotFoundError(f"no valid checkpoint in {self.directory}")

    def has_checkpoint(self) -> bool:
        return bool(store.list_steps(self.directory))

    # ------------------------------------------------------------------ #
    def install_sigterm_drain(self, get_state: Callable[[], Tuple[Any, int]]
                              ) -> None:
        def handler(signum, frame):  # pragma: no cover - signal path
            log.warning("SIGTERM: draining with a final checkpoint")
            state, step = get_state()
            self.save(state, step, block=True)
            raise SystemExit(0)

        signal.signal(signal.SIGTERM, handler)
