"""Cache-insertion priorities and cache-replacement policies — for
REQUESTS (preemption victims) and for the PAGE POOL's prefix registry.

Insertion (GROUPREQUESTS, Table 2):
  * ``prefill_first`` — vLLM: {R_w, R_r}
  * ``decode_first``  — Sarathi/ORCA: {R_r^d, R_r^p, R_w}
Within each group requests are ordered by a ranking key:
  * ``arrival`` (FCFS, default), ``input`` (Rank_I), ``output`` (Rank_O —
    hypothetical: reads r.output_len).

Request replacement (victim selection on memory pressure):
  * ``nrf`` — newest request first (vLLM/Sarathi default)
  * ``srf`` — shortest request first: preempt the request with the fewest
    cached tokens m (the paper's contribution, §8)
  * ``lrf`` — longest request first (ablation / anti-policy)
  * ``pf``  — preemption-free: never select a victim (callers must reserve
    peak memory up front)

Page-pool replacement (``ReplacementPolicy``, the §6 five-minute-rule
contribution): when the free list runs short the ``PagedAllocator``
reclaims cached-prefix registry entries in the order a pluggable policy
ranks them:

  * ``lru``          — least-recently-used entry first (the pre-policy
    hard-wired behaviour; hit-rate-blind under skewed popularity)
  * ``break_even``   — Gray/Putzolu Eq. 5 applied per entry: score each
    cached prefix page by observed idle time over its break-even
    residency interval ``break_even_interval(model, n_kvs, M)``.  The
    interval FALLS with chain depth (weight-load amortizes), so at equal
    idle time LONG prefixes evict sooner — exactly the paper's
    prediction — while frequently-hit short prefixes survive scans that
    flush LRU.
  * ``belady-oracle``— evict the entry whose next access lies farthest
    in the future (offline ablation; needs the workload's future access
    times, e.g. ``belady_future_from_requests``).
"""
from __future__ import annotations

import bisect
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.request import Phase, Request

# --------------------------------------------------------------------- #
# insertion
# --------------------------------------------------------------------- #


def ranking_key(ranking: str):
    if ranking == "arrival":
        return lambda r: (r.arrival, r.rid)
    if ranking == "input":
        return lambda r: (r.input_len, r.arrival, r.rid)
    if ranking == "output":  # hypothetical
        return lambda r: (r.output_len, r.arrival, r.rid)
    raise ValueError(f"unknown ranking {ranking!r}")


def group_requests(waiting: Sequence[Request], running: Sequence[Request], *,
                   priority: str, ranking: str = "arrival") -> List[Request]:
    """Return all candidates in global priority order (paper step 1)."""
    key = ranking_key(ranking)
    w = sorted(waiting, key=key)
    if priority == "prefill_first":
        r = sorted(running, key=key)
        return w + r
    if priority == "decode_first":
        rd = sorted((r for r in running if r.phase == Phase.DECODE), key=key)
        rp = sorted((r for r in running if r.phase == Phase.PREFILL), key=key)
        return rd + rp + w
    raise ValueError(f"unknown priority {priority!r}")


# --------------------------------------------------------------------- #
# replacement
# --------------------------------------------------------------------- #


def select_victim(policy: str, candidates: Sequence[Request]
                  ) -> Optional[Request]:
    """Choose which running request to preempt (paper step 4)."""
    if not candidates or policy == "pf":
        return None
    if policy == "nrf":
        return max(candidates, key=lambda r: (r.arrival, r.rid))
    if policy == "srf":
        return min(candidates, key=lambda r: (r.m, -r.arrival, -r.rid))
    if policy == "lrf":
        return max(candidates, key=lambda r: (r.m, r.arrival, r.rid))
    raise ValueError(f"unknown replacement policy {policy!r}")


# --------------------------------------------------------------------- #
# page-pool replacement (§6 five-minute rule on the prefix registry)
# --------------------------------------------------------------------- #


class ReplacementPolicy:
    """Eviction ranking over cached-prefix registry entries — since the
    radix-trie registry (PR 9), one entry per TRIE NODE, keyed by the
    node's first chain key and scored with the node's END-depth
    ``n_kvs``.

    The ``RadixPrefixRegistry`` feeds every insert/hit/remove through
    the policy, plus :meth:`record_resize` when a node's run grows
    (incremental registration, merges) or shrinks (tail eviction,
    splits) without being touched by a request — depth changes must
    reprice Eq. 5 without counterfeiting recency.  ``eviction_order``
    returns ALL tracked keys, most-evictable first; with ``leaf_of``
    given, current leaves sort before interior nodes (an interior
    eviction would strand live descendants — the registry's sweep
    re-walks as leaves fall, so parents surface in a later pass).
    Drivers skip entries whose pages a live block table still maps
    (evicting those frees nothing).  Higher :meth:`rank` = evict
    earlier; ties break on insertion order, then key, so the order is
    fully deterministic.
    """

    name = "base"

    def __init__(self) -> None:
        self._seq: Dict[int, int] = {}   # key -> insertion sequence no.
        self._n = 0

    def record_insert(self, key: int, n_kvs: int, now: float) -> None:
        self._n += 1
        self._seq[key] = self._n

    def record_hit(self, key: int, now: float) -> None:
        pass

    def record_remove(self, key: int) -> None:
        self._seq.pop(key, None)

    def record_resize(self, key: int, n_kvs: int) -> None:
        """A node's run changed length: update depth-derived state
        WITHOUT refreshing recency (LRU and Belady carry none)."""
        pass

    def rank(self, key: int, now: float) -> float:  # pragma: no cover
        raise NotImplementedError

    def eviction_order(self, now: float,
                       leaf_of: Optional[Callable[[int], bool]] = None
                       ) -> List[int]:
        keys = sorted(self._seq,
                      key=lambda k: (-self.rank(k, now), self._seq[k], k))
        if leaf_of is None:
            return keys
        leaves = [k for k in keys if leaf_of(k)]
        return leaves + [k for k in keys if not leaf_of(k)]

    def __len__(self) -> int:
        return len(self._seq)


class LRUPolicy(ReplacementPolicy):
    """Least-recently-used: insert and hit both refresh recency."""

    name = "lru"

    def record_hit(self, key: int, now: float) -> None:
        self._n += 1
        self._seq[key] = self._n

    def rank(self, key: int, now: float) -> float:
        return -float(self._seq[key])


class BreakEvenPolicy(ReplacementPolicy):
    """Five-minute-rule replacement (paper §6, Eq. 5).

    Each entry carries its chain depth ``n_kvs`` (the prefix length the
    page terminates, in tokens).  Break-even residency
    ``B(n) = t_regen(n)/n * M`` falls with ``n`` — regenerating a long
    prefix is cheap PER KV because the weight-load cost amortizes — so
    the score ``idle / B(n)`` evicts the entry whose expected
    regeneration cost per freed page is lowest: long cold prefixes go
    first, frequently-hit short prefixes stay resident well past an LRU
    horizon.  ``mode`` selects which regeneration path prices ``B``
    (``kv_projection`` — Fig. 8's activation-cached rebuild — ``full``,
    or ``swap`` when a host demotion tier makes the swap-in the actual
    regeneration cost).
    """

    name = "break_even"

    def __init__(self, cost_model, M: int, *,
                 mode: str = "kv_projection") -> None:
        super().__init__()
        if cost_model is None or M <= 0:
            raise ValueError(f"break_even needs a cost model and M > 0, "
                             f"got {(cost_model, M)}")
        self.cost_model = cost_model
        self.M = M
        self.mode = mode
        self._meta: Dict[int, Tuple[int, float]] = {}  # key -> (n, last)
        self._intervals: Dict[int, float] = {}

    def _interval(self, n_kvs: int) -> float:
        iv = self._intervals.get(n_kvs)
        if iv is None:
            from repro_torch.core.five_minute_rule import break_even_interval
            iv = break_even_interval(self.cost_model, n_kvs, self.M,
                                     mode=self.mode).interval
            iv = max(iv, 1e-12)        # swap-unmodeled cost models -> 0
            self._intervals[n_kvs] = iv
        return iv

    def record_insert(self, key: int, n_kvs: int, now: float) -> None:
        super().record_insert(key, n_kvs, now)
        self._meta[key] = (max(int(n_kvs), 1), now)

    def record_hit(self, key: int, now: float) -> None:
        n, _ = self._meta[key]
        self._meta[key] = (n, now)

    def record_resize(self, key: int, n_kvs: int) -> None:
        # node-depth-aware n_kvs: a tail eviction/split shrinks the
        # node's end depth, a merge/extension grows it — reprice Eq. 5
        # at the new depth but keep the observed last-hit time
        _, last = self._meta[key]
        self._meta[key] = (max(int(n_kvs), 1), last)

    def record_remove(self, key: int) -> None:
        super().record_remove(key)
        self._meta.pop(key, None)

    def rank(self, key: int, now: float) -> float:
        n, last = self._meta[key]
        return max(now - last, 0.0) / self._interval(n)


class BeladyOraclePolicy(ReplacementPolicy):
    """Offline MIN/OPT ablation: evict the entry whose NEXT access lies
    farthest in the future (never-again entries first).  ``future`` maps
    each chain key to its access times; entries with no future entry are
    treated as never accessed again."""

    name = "belady"

    def __init__(self, future: Optional[Dict[int, Sequence[float]]] = None
                 ) -> None:
        super().__init__()
        self.future: Dict[int, List[float]] = {
            k: sorted(v) for k, v in (future or {}).items()}

    def rank(self, key: int, now: float) -> float:
        times = self.future.get(key)
        if times:
            i = bisect.bisect_right(times, now)
            if i < len(times):
                return times[i]
        return float("inf")


def make_replacement_policy(name: str, *, cost_model=None, M: int = 0,
                            mode: str = "kv_projection",
                            future: Optional[Dict[int, Sequence[float]]]
                            = None) -> ReplacementPolicy:
    """Factory for the page-pool policies (``SchedulerConfig.
    cache_policy`` names land here)."""
    key = name.lower().replace("-", "_")
    if key == "lru":
        return LRUPolicy()
    if key == "break_even":
        if cost_model is None or M <= 0:
            raise ValueError(
                "break_even replacement needs a cost model and M > 0")
        return BreakEvenPolicy(cost_model, M, mode=mode)
    if key in ("belady", "belady_oracle"):
        return BeladyOraclePolicy(future)
    raise ValueError(f"unknown cache replacement policy {name!r}")


def belady_future_from_requests(requests: Iterable[Request],
                                page_size: int
                                ) -> Dict[int, List[float]]:
    """Chain-key -> sorted arrival times over a known offline workload —
    the oracle's future-access table (requests need real prompts).
    Trie nodes are keyed by their FIRST chain key, so per-page futures
    index node entries directly (the oracle sees the node's head)."""
    from repro_torch.core.kvcache import chain_keys

    future: Dict[int, List[float]] = {}
    for r in requests:
        if r.prompt is None:
            continue
        for key in chain_keys(r.prompt, page_size):
            future.setdefault(key, []).append(r.arrival)
    return {k: sorted(v) for k, v in future.items()}
