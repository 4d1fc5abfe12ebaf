"""Host-side KV swap store — the §5.4 suspend/resume data plane.

When the scheduler preempts a victim in ``swap`` mode, the engine
snapshots the victim's per-slot cache slice (every cache leaf, including
the position index and any recurrent SSM state) to HOST memory as NumPy
arrays, together with the request's sampled token ids.  On re-admission
the snapshot is written back into a (possibly different) free slot and
generation continues — no refill prefill, bit-identical state.

The store is pure bookkeeping: one entry per suspended rid, explicit
byte accounting, and fail-fast invariants (double-put and missing-pop
raise).  An optional ``capacity_bytes`` bound models finite host memory;
exceeding it raises ``SwapStoreFullError`` so callers can fall back to
discard-and-recompute.

Three entry granularities share the byte budget:

* ``SwapEntry`` — a whole contiguous slot slice (the batched/legacy
  planes' full suspend).
* ``PageRunEntry`` — a contiguous run of pool PAGES (the paged plane's
  §8 page-level partial preemption; also how the paged plane stores a
  full suspend: one run covering every device page).  Runs for one rid
  stack as the tail is shed repeatedly and always tile a contiguous
  span, restored together in ascending-start order.
* ``PrefixPageEntry`` — the HOST DEMOTION TIER of the prefix cache: a
  refcount-free snapshot of ONE registry page evicted by the page-pool
  replacement policy, keyed by its chain hash (not a rid — no request
  owns it).  A later registry miss that matches the key (token-verified,
  like the device registry) promotes it back through the swap path.
  Unlike suspend entries, demoted prefixes may legitimately outlive the
  run — ``__len__`` counts only suspend bookkeeping, so end-of-run
  leak checks stay meaningful.

Integrity: every entry kind carries an optional CRC32 *seal*
(``seal_entry``, computed once over the host bytes when they
materialize — at put for sync paths, at drain for async ones) that
``verify_entry`` re-checks at swap-in / promotion.  A mismatch means
the host snapshot rotted (or the fault plan flipped a bit in it); the
caller drops the entry and degrades the request to recompute rather
than ever restoring wrong KV.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.invariants import invariant


class SwapStoreFullError(RuntimeError):
    pass


def _tree_nbytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    return int(np.asarray(tree).nbytes)


def _tree_crc(tree: Any, crc: int = 0) -> int:
    """CRC32 over every array leaf, traversed in a deterministic order
    (sorted dict keys) so the seal is content-addressed."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            crc = _tree_crc(tree[k], crc)
        return crc
    if isinstance(tree, (list, tuple)):
        for v in tree:
            crc = _tree_crc(v, crc)
        return crc
    arr = np.ascontiguousarray(np.asarray(tree))
    return zlib.crc32(arr.tobytes(), crc)


def seal_entry(entry: Any) -> None:
    """Stamp ``entry.crc`` from its host bytes.  Idempotent: a second
    seal is a no-op, which matters for crash recovery — after a step
    rollback the engine may re-drain an entry whose bytes were already
    sealed (and possibly corrupted by the fault plan); re-sealing would
    bless the corruption."""
    if entry.crc is not None:
        return
    data = entry.cache if isinstance(entry, SwapEntry) else entry.kv
    if data is None:
        return                       # metadata-only shadow (simulator)
    entry.crc = _tree_crc(data)


def verify_entry(entry: Any) -> bool:
    """True iff the entry's bytes still match its seal (unsealed or
    metadata-only entries verify trivially)."""
    if entry.crc is None:
        return True
    data = entry.cache if isinstance(entry, SwapEntry) else entry.kv
    if data is None:
        return True
    return _tree_crc(data) == entry.crc


def _leaf_sites(tree: Any):
    """Yield ``(parent, key, nbytes)`` for every array leaf reachable
    through a mutable container (dict/list)."""
    if isinstance(tree, dict):
        items = [(tree, k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(tree, i, v) for i, v in enumerate(tree)]
    else:
        return
    for parent, key, val in items:
        if isinstance(val, (dict, list, tuple)):
            yield from _leaf_sites(val)
        else:
            yield parent, key, int(np.asarray(val).nbytes)


def flip_bit(tree: Any) -> bool:
    """Corrupt the *largest* array leaf (one bit of byte 0) — the fault
    plan's model of host-memory rot.  Targeting the biggest buffer
    models where rot lands in practice (the KV bytes, not the few-byte
    bookkeeping arrays riding in the same pytree) and keeps metadata
    like the slot ``index`` array intact for the engine's drain-time
    sanity asserts.  ``jax.device_get`` may hand back read-only views,
    so the leaf is *replaced* in its parent container by a flipped host
    copy rather than mutated in place.  Returns False if no leaf is
    reachable through a mutable container."""
    best = None
    for parent, key, nbytes in _leaf_sites(tree):
        if nbytes and (best is None or nbytes > best[2]):
            best = (parent, key, nbytes)
    if best is None or isinstance(best[0], tuple):
        return False
    parent, key, _ = best
    arr = np.array(np.asarray(parent[key]), copy=True)
    arr.view(np.uint8).reshape(-1)[0] ^= 1
    parent[key] = arr
    return True


@dataclass
class SwapEntry:
    rid: int
    cache: Any                   # pytree of host (NumPy) arrays, one slot
    tokens: List[int]            # prompt + sampled tokens at suspend time
    num_kv: int                  # KV tokens held (Request.suspended_m)
    nbytes: int = field(default=0)
    crc: Optional[int] = None    # integrity seal (seal_entry)
    corrupt: bool = False        # fault-plan marker: bytes were flipped

    def __post_init__(self) -> None:
        if not self.nbytes:
            self.nbytes = _tree_nbytes(self.cache)


@dataclass
class PageRunEntry:
    """Page-granular snapshot: a contiguous run of a request's KV pages
    (the §8 partial-preemption unit).  ``kv`` holds the gathered pool
    pages per layer — ``{"k": (L, n_pages, page, Hkv, D), "v": ...}`` —
    and ``start`` is the absolute token position of the run's first
    token (always page-aligned).  Runs for one rid tile [0, suspended
    tokens) contiguously; only the topmost run may end mid-page."""
    rid: int
    start: int
    num_tokens: int
    kv: Any
    nbytes: int = field(default=0)
    crc: Optional[int] = None
    corrupt: bool = False

    def __post_init__(self) -> None:
        if not self.nbytes:
            self.nbytes = _tree_nbytes(self.kv)


@dataclass
class PrefixPageEntry:
    """Host-demoted prefix-cache page (refcount-free: keyed by chain
    hash, owned by no request).  ``tokens`` are the page's token ids
    (collision verification at promotion, exactly like the device
    registry); ``n_kvs`` the chain depth the replacement policy scores
    with; ``kv`` the per-layer page snapshot ``{"k": (L, 1, page, Hkv,
    D), "v": ...}`` — or None for metadata-only shadows (the simulator
    charges virtual time without moving bytes; pass ``nbytes``)."""
    key: int
    tokens: tuple
    n_kvs: int
    kv: Any
    nbytes: int = field(default=0)
    crc: Optional[int] = None
    corrupt: bool = False

    def __post_init__(self) -> None:
        if not self.nbytes and self.kv is not None:
            self.nbytes = _tree_nbytes(self.kv)


class KVSwapStore:
    """rid -> suspended slot snapshot, with byte accounting."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        if not (capacity_bytes is None or capacity_bytes > 0):
            raise ValueError(f"capacity_bytes={capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        self._entries: Dict[int, SwapEntry] = {}
        self._runs: Dict[int, List[PageRunEntry]] = {}
        self._prefixes: Dict[int, PrefixPageEntry] = {}
        self._nbytes = 0

    # ------------------------------------------------------------------ #
    def put(self, rid: int, cache: Any, tokens: List[int],
            num_kv: int, nbytes: int = 0) -> SwapEntry:
        """Suspend rid's slot snapshot.  One live entry per rid.

        ``nbytes`` lets callers charge capacity from array metadata
        without forcing a host transfer — the async swap-out path hands
        over device arrays whose D2H copy is still in flight and
        finalizes the entry at drain time."""
        if rid in self._entries:
            raise ValueError(f"rid {rid} already suspended")
        if num_kv <= 0:
            raise ValueError(f"rid {rid}: num_kv={num_kv}")
        entry = SwapEntry(rid=rid, cache=cache, tokens=list(tokens),
                          num_kv=num_kv, nbytes=nbytes)
        if (self.capacity_bytes is not None
                and self._nbytes + entry.nbytes > self.capacity_bytes):
            raise SwapStoreFullError(
                f"rid {rid}: {entry.nbytes}B over capacity "
                f"({self._nbytes}/{self.capacity_bytes}B held)")
        self._entries[rid] = entry
        self._nbytes += entry.nbytes
        return entry

    def pop(self, rid: int) -> SwapEntry:
        """Restore rid: removes and returns its snapshot."""
        entry = self._entries.pop(rid, None)
        if entry is None:
            raise KeyError(f"rid {rid} not suspended")
        self._nbytes -= entry.nbytes
        return entry

    def peek(self, rid: int) -> SwapEntry:
        return self._entries[rid]

    def discard(self, rid: int) -> bool:
        """Drop a snapshot without restoring (request aborted)."""
        entry = self._entries.pop(rid, None)
        if entry is None:
            return False
        self._nbytes -= entry.nbytes
        return True

    # --- page-granular runs (partial preemption, §8) ------------------- #
    def put_run(self, rid: int, start: int, num_tokens: int,
                kv: Any, nbytes: int = 0) -> PageRunEntry:
        """Suspend one contiguous run of rid's KV pages.  Runs stack:
        later runs sit BELOW earlier ones (the tail is shed top-down), so
        entries for a rid always tile a suffix of its context.

        ``nbytes`` mirrors ``put``: the async page-run path hands over a
        device-side gather whose D2H copy is still in flight and charges
        capacity from array metadata; the entry is finalized at drain."""
        if num_tokens <= 0:
            raise ValueError(f"rid {rid}: num_tokens={num_tokens}")
        entry = PageRunEntry(rid=rid, start=start, num_tokens=num_tokens,
                             kv=kv, nbytes=nbytes)
        if (self.capacity_bytes is not None
                and self._nbytes + entry.nbytes > self.capacity_bytes):
            raise SwapStoreFullError(
                f"rid {rid} run: {entry.nbytes}B over capacity "
                f"({self._nbytes}/{self.capacity_bytes}B held)")
        runs = self._runs.setdefault(rid, [])
        if any(r.start == start for r in runs):
            raise ValueError(f"rid {rid}: run at start {start} exists")
        runs.append(entry)
        self._nbytes += entry.nbytes
        return entry

    def pop_runs(self, rid: int) -> List[PageRunEntry]:
        """Restore ALL of rid's page runs, sorted by ascending start (the
        order they must be scattered back in)."""
        runs = self._runs.pop(rid, None)
        if not runs:
            raise KeyError(f"rid {rid} has no page runs")
        self._nbytes -= sum(r.nbytes for r in runs)
        return sorted(runs, key=lambda r: r.start)

    def discard_runs(self, rid: int) -> int:
        """Drop rid's page runs without restoring (fallback to
        recompute).  Returns the number of runs dropped."""
        runs = self._runs.pop(rid, None)
        if not runs:
            return 0
        self._nbytes -= sum(r.nbytes for r in runs)
        return len(runs)

    def has_runs(self, rid: int) -> bool:
        return bool(self._runs.get(rid))

    def peek_runs(self, rid: int) -> List[PageRunEntry]:
        """Read-only view of rid's stored runs (integrity checks)."""
        return list(self._runs.get(rid, []))

    def run_tokens(self, rid: int) -> int:
        return sum(r.num_tokens for r in self._runs.get(rid, []))

    # --- host demotion tier of the prefix cache ------------------------ #
    def put_prefix(self, key: int, tokens, n_kvs: int, kv: Any,
                   nbytes: int = 0) -> PrefixPageEntry:
        """Demote one evicted registry page to host memory."""
        if key in self._prefixes:
            raise ValueError(f"prefix key {key} already demoted")
        entry = PrefixPageEntry(key=key, tokens=tuple(tokens),
                                n_kvs=int(n_kvs), kv=kv, nbytes=nbytes)
        if (self.capacity_bytes is not None
                and self._nbytes + entry.nbytes > self.capacity_bytes):
            raise SwapStoreFullError(
                f"prefix key {key}: {entry.nbytes}B over capacity "
                f"({self._nbytes}/{self.capacity_bytes}B held)")
        self._prefixes[key] = entry
        self._nbytes += entry.nbytes
        return entry

    def peek_prefix(self, key: int,
                    tokens=None) -> Optional[PrefixPageEntry]:
        """Host-tier lookup; a token mismatch (hash collision) is a
        MISS, never another prompt's KV."""
        entry = self._prefixes.get(key)
        if entry is None:
            return None
        if tokens is not None and tuple(tokens) != entry.tokens:
            return None
        return entry

    def pop_prefix(self, key: int) -> PrefixPageEntry:
        """Promote: remove and return the demoted page snapshot."""
        entry = self._prefixes.pop(key, None)
        if entry is None:
            raise KeyError(f"prefix key {key} not demoted")
        self._nbytes -= entry.nbytes
        return entry

    def discard_prefix(self, key: int) -> bool:
        entry = self._prefixes.pop(key, None)
        if entry is None:
            return False
        self._nbytes -= entry.nbytes
        return True

    def has_prefix(self, key: int) -> bool:
        return key in self._prefixes

    @property
    def num_prefix_entries(self) -> int:
        return len(self._prefixes)

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        # suspend bookkeeping only: demoted prefixes (keyed by chain
        # hash, not rid) may outlive the run by design
        return len(self._entries) + len(self._runs)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries or rid in self._runs

    @property
    def nbytes(self) -> int:
        return self._nbytes

    @property
    def suspended_rids(self) -> List[int]:
        return sorted(set(self._entries) | set(self._runs))

    def check_invariants(self) -> None:
        recount = sum(e.nbytes for e in self._entries.values()) \
            + sum(r.nbytes for runs in self._runs.values() for r in runs) \
            + sum(p.nbytes for p in self._prefixes.values())
        invariant(recount == self._nbytes, (recount, self._nbytes))
        if self.capacity_bytes is not None:
            invariant(self._nbytes <= self.capacity_bytes,
                      (self._nbytes, self.capacity_bytes))
        for rid, e in self._entries.items():
            invariant(rid == e.rid and e.num_kv > 0, (rid, e.rid, e.num_kv))
        for key, p in self._prefixes.items():
            invariant(key == p.key and p.n_kvs > 0, (key, p.key, p.n_kvs))
        for rid, runs in self._runs.items():
            invariant(runs, rid)
            # runs tile a contiguous [min_start, end) span, no overlap
            spans = sorted((r.start, r.num_tokens) for r in runs)
            for (s0, n0), (s1, _) in zip(spans, spans[1:]):
                invariant(s0 + n0 == s1, (rid, spans))
            for r in runs:
                invariant(r.rid == rid and r.num_tokens > 0, (rid, r))
