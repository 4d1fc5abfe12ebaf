"""Step-scoped transactions for the serving control plane.

The engine's batch loop mutates four coupled state machines per step —
the :class:`PagedAllocator` (tables, refcounts, prefix registry), the
:class:`KVSwapStore` (byte-accounted host snapshots), the
:class:`Scheduler` (queues, counters, histogram), and every
:class:`Request`'s own state machine — plus engine-local slot/output
maps.  A failure between claim/attach/CoW and pricing used to leak
pages and strand registry entries; a :class:`StepTxn` makes the step
atomic: snapshot everything at batch start, and on a mid-step fault
restore every participant to exactly that point, so the retried (or
degraded) step starts from a state where ``check_invariants`` holds.

Snapshots are cheap by construction:

* Device KV (the batched slot cache, the paged per-layer pools) needs
  **no** copying — JAX arrays are immutable, so saving the *references*
  (``engine.cache`` / ``engine.k_pools`` / ``engine.v_pools``) and
  restoring them rolls back every in-step scatter.  The engine does
  this itself; this module covers the Python-side state.
* Python state is snapshotted one-to-two container levels deep:
  request/entry *objects* are shared by reference (their mutable
  fields are captured separately), inner tuples are immutable.
* Replacement policies and the histogram are captured generically via
  :func:`copy_state` (container attributes copied, leaf objects like
  the policy's ``cost_model`` shared by reference).

The simulator's shadow (``core.simulator``) reuses these functions —
lazily imported there — so engine and simulator roll back through the
same code and stay in parity batch-for-batch under injected faults.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

from repro_torch.core.kvcache import BlockTable, PagedAllocator
from repro_torch.core.request import Request

# Request fields mutated by the state machine mid-step.  ``token_times``
# is the one mutable container; everything else is a scalar.
_REQUEST_FIELDS = (
    "m", "generated", "running", "preemptions", "suspended",
    "suspended_m", "swaps", "tail_suspended_m", "partial_preemptions",
    "swap_out_m", "first_token_time", "finish_time", "predicted_output",
)


def _copy_val(v: Any, depth: int = 2) -> Any:
    """Copy dict/list/set containers up to ``depth`` levels; share
    everything else (objects, tuples, scalars) by reference."""
    if isinstance(v, dict):
        if depth <= 1:
            return v.copy()            # preserves OrderedDict order/type
        out = v.copy()
        for k, x in out.items():
            out[k] = _copy_val(x, depth - 1)
        return out
    if isinstance(v, list):
        return [_copy_val(x, depth - 1) for x in v] if depth > 1 \
            else list(v)
    if isinstance(v, set):
        return set(v)
    return v


def copy_state(obj: Any) -> Dict[str, Any]:
    """Generic ``__dict__`` snapshot (containers copied two levels
    deep, leaves shared).  Suits the replacement policies (whose only
    mutable state is dicts of scalars/tuples) and the histogram."""
    return {k: _copy_val(v) for k, v in obj.__dict__.items()}


def restore_state(obj: Any, snap: Dict[str, Any]) -> None:
    obj.__dict__.clear()
    obj.__dict__.update(snap)


# --------------------------------------------------------------------- #
# participant snapshots
# --------------------------------------------------------------------- #

def snapshot_allocator(alloc: PagedAllocator) -> Callable[[], None]:
    """Capture the allocator (tables, free list, refcounts, pins,
    virtual clock, stats) *and* its radix-trie prefix registry +
    replacement policy.

    The trie is a snapshot participant in its own right
    (``RadixPrefixRegistry.snapshot_state``): a rolled-back step undoes
    node inserts, splits, merges, and tail evictions structurally.
    Node REFCOUNTS need no capture — they are derived from the
    allocator's page refcounts, which this snapshot already restores,
    so structure and leases can never roll back out of sync."""
    free = list(alloc._free)
    tables = {rid: BlockTable(list(t.pages), t.num_tokens)
              for rid, t in alloc._tables.items()}
    refs = dict(alloc._refs)
    pinned = set(alloc._pinned)
    now, version = alloc.now, alloc.version
    dirty = set(alloc.dirty)
    stats = dict(alloc.stats)
    pc = alloc.prefix_cache
    pc_state = pc.snapshot_state()
    policy_state = copy_state(pc.policy)

    def restore() -> None:
        alloc._free = list(free)
        alloc._tables = {rid: BlockTable(list(t.pages), t.num_tokens)
                         for rid, t in tables.items()}
        alloc._refs = dict(refs)
        alloc._pinned = set(pinned)
        alloc.now, alloc.version = now, version
        alloc.dirty = set(dirty)
        alloc.stats = dict(stats)
        pc.restore_state(pc_state)
        restore_state(pc.policy, {k: _copy_val(v)
                                  for k, v in policy_state.items()})
    return restore


def snapshot_store(store: Any) -> Callable[[], None]:
    """Capture the swap store's entry maps and byte accounting.

    Entry *objects* are shared by reference: post-rollback in-place
    mutations on pre-existing entries (async-drain materialization,
    CRC sealing, the idempotent corruption flip) are convergent by
    design — see ``swap_store.seal_entry``."""
    entries = dict(store._entries)
    runs = {rid: list(rs) for rid, rs in store._runs.items()}
    prefixes = dict(store._prefixes)
    nbytes = store._nbytes

    def restore() -> None:
        store._entries = dict(entries)
        store._runs = {rid: list(rs) for rid, rs in runs.items()}
        store._prefixes = dict(prefixes)
        store._nbytes = nbytes
    return restore


def snapshot_scheduler(sched: Any) -> Callable[[], None]:
    waiting, running = list(sched.waiting), list(sched.running)
    counters = (sched.num_preemptions, sched.num_partial_preempts,
                sched.num_swaps, sched.num_batches)
    hist = copy_state(sched.histogram) if sched.histogram is not None \
        else None

    def restore() -> None:
        sched.waiting, sched.running = list(waiting), list(running)
        (sched.num_preemptions, sched.num_partial_preempts,
         sched.num_swaps, sched.num_batches) = counters
        if hist is not None:
            restore_state(sched.histogram,
                          {k: _copy_val(v) for k, v in hist.items()})
    return restore


def snapshot_requests(requests: List[Request]) -> Callable[[], None]:
    saved = [(r, {f: getattr(r, f) for f in _REQUEST_FIELDS},
              list(r.token_times)) for r in requests]

    def restore() -> None:
        for r, fields, times in saved:
            for f, v in fields.items():
                setattr(r, f, v)
            r.token_times = list(times)
    return restore


# --------------------------------------------------------------------- #
# the transaction object
# --------------------------------------------------------------------- #

class StepTxn:
    """An undo journal over one scheduler batch.

    ``add`` registers restore closures (typically the ``snapshot_*``
    functions above plus driver-local ones); ``rollback`` replays them
    LIFO.  A txn may be rolled back at most once — the driver opens a
    fresh one per attempt, so snapshots are never reused."""

    def __init__(self) -> None:
        self._restores: List[Callable[[], None]] = []
        self.rolled_back = False

    def add(self, restore: Callable[[], None]) -> None:
        self._restores.append(restore)

    def rollback(self) -> None:
        if self.rolled_back:
            raise RuntimeError("StepTxn rolled back twice")
        for restore in reversed(self._restores):
            restore()
        self.rolled_back = True


def begin_step_txn(*, scheduler=None, allocator=None, store=None,
                   requests=None) -> StepTxn:
    """Convenience constructor covering the common participants; the
    driver adds its own locals with ``txn.add``."""
    txn = StepTxn()
    if scheduler is not None:
        txn.add(snapshot_scheduler(scheduler))
    if allocator is not None:
        txn.add(snapshot_allocator(allocator))
    if store is not None:
        txn.add(snapshot_store(store))
    if requests is not None:
        txn.add(snapshot_requests(list(requests)))
    return txn
