"""Deterministic fault injection for the serving control plane.

A :class:`FaultPlan` is a *pure function* from (seed, fault kind,
content key) to "fail or not".  Both the engine and the simulator
build their own plan from the same :class:`FaultSpec` (threaded
through ``EngineConfig``/``SchedulerConfig`` like ``page_size``) and
consult it at the same decision points with the same keys, so the two
sides observe the *same* fault schedule without sharing any mutable
state — that is what keeps engine-vs-simulator parity byte-exact under
injected faults.

Content keying (rather than a draw counter) makes draws idempotent:
when the engine aborts a step attempt, rolls back, and retries, the
re-issued store puts see the same verdicts, so a fault schedule cannot
drift between an aborted attempt and its successful retry (or between
the engine, which aborts, and the simulator, which never does).  The
one exception is page-allocation faults, which model *transient device
errors*: those are keyed by (step, attempt, ordinal) so a retried
attempt clears them — they are trace-free aborts the simulator never
sees.

Hashing is ``zlib.crc32`` over ``repr`` of the key tuple — stable
across processes (unlike salted ``hash()``), cheap, and uniform enough
for fault rates.

Prefix demotions interact with the radix trie (PR 9) page-by-page: an
evicted node run lands in the host tier as consecutive
``PrefixPageEntry`` snapshots, each CRC-sealed and each drawing its
own ``corrupt_prefix`` / ``promote_fail`` verdict under its chain key.
A failed verdict mid-run therefore truncates the promotion exactly
where the rot is — the surviving front still attaches (the trie's
partial-hit path) and only the tail recomputes.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, List, Optional, Tuple

from repro_torch.serving.swap_store import SwapStoreFullError


class FaultError(RuntimeError):
    """An injected transient device fault (e.g. page allocation).

    Aborts the current step attempt; the engine rolls back to batch
    start and retries the step.  Never escapes ``Engine.step``.
    """


class TransientStoreError(RuntimeError):
    """A swap-store write failed transiently; retried with backoff."""


class PermanentStoreError(SwapStoreFullError):
    """A swap-store write failed permanently.

    Subclasses ``SwapStoreFullError`` so every existing store-full
    fallback path — drop the snapshot, count a ``swap_fallbacks``,
    degrade the victim to recompute — handles it unchanged.
    """


class IntegrityError(RuntimeError):
    """A host-resident KV snapshot failed its CRC (or was marked
    corrupt by the fault plan) at swap-in / promote time.

    Carries ``repairs``: closures the engine applies *after* rolling
    the step back, which drop the corrupt entry and degrade the victim
    request to recompute.  The retried step then schedules without the
    poisoned snapshot.
    """

    def __init__(self, message: str,
                 repairs: Optional[List[Callable[[], None]]] = None):
        super().__init__(message)
        self.repairs: List[Callable[[], None]] = list(repairs or [])


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative fault rates, all in [0, 1] (0 = never)."""
    seed: int = 0
    p_alloc: float = 0.0            # transient page-allocation failure
    p_store_transient: float = 0.0  # store put fails, succeeds on retry
    p_store_permanent: float = 0.0  # store put fails for good
    p_corrupt: float = 0.0          # host snapshot corrupted after put
    p_demote_fail: float = 0.0      # async prefix demotion never lands
    p_promote_fail: float = 0.0     # prefix promotion read fails

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name == "seed":
                continue
            v = getattr(self, f.name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{f.name}={v} outside [0, 1]")


class FaultPlan:
    """Seeded, stateless oracle answering "does this operation fail?"."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec

    # ------------------------------------------------------------- #
    # core draw
    # ------------------------------------------------------------- #
    def _unit(self, kind: str, key: Tuple) -> float:
        h = zlib.crc32(repr((self.spec.seed, kind, key)).encode())
        return h / 2 ** 32

    def decide(self, kind: str, *key) -> bool:
        p = getattr(self.spec, "p_" + _RATE_OF[kind])
        return p > 0.0 and self._unit(kind, key) < p

    # ------------------------------------------------------------- #
    # named draws
    # ------------------------------------------------------------- #
    def alloc_fault(self, step_no: int, attempt: int, ordinal: int) -> bool:
        """Transient device fault on the ordinal-th page allocation of
        this (step, attempt).  Attempt-keyed: a retried step draws
        fresh, so allocation faults cannot livelock the step loop."""
        return self.decide("alloc", step_no, attempt, ordinal)

    def transient_failures(self, kind: str, *key) -> int:
        """How many times this store put fails transiently before
        succeeding: 0 (common) or a content-derived count in 1..3 —
        always within ``run_with_retries``'s budget, so a transient
        fault alone never escalates."""
        if not self.decide(kind, *key):
            return 0
        return 1 + zlib.crc32(
            repr((self.spec.seed, "k_fail", kind, key)).encode()) % 3


# Maps draw kind -> FaultSpec rate field.  Distinct kinds over the same
# key hash independently (the kind is inside the CRC).
_RATE_OF = {
    "alloc": "alloc",
    "store_put": "store_transient",      # full-suspend snapshot put
    "store_run": "store_transient",      # tail-shed page-run put
    "perm_put": "store_permanent",
    "perm_run": "store_permanent",
    "corrupt_put": "corrupt",
    "corrupt_run": "corrupt",
    "corrupt_prefix": "corrupt",
    "demote_fail": "demote_fail",
    "promote_fail": "promote_fail",
}
