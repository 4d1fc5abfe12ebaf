"""Gray & Putzolu's five-minute rule applied to KV caches (paper §6).

Break-even interval for keeping the N KVs of a completed request resident
in the KV cache rather than recomputing them on the next access:

    interval(N) = t_recom(N) / N * M            (Eq. 5)

where t_recom(N) is the time to recompute N KVs (one prefill of c = N) and
M the KV-cache capacity in tokens.  The price terms cancel because both
sides are measured in GPU-seconds.  Because t_recom(N)/N *falls* with N
(the fixed weight-load cost amortizes), longer requests have SHORTER
break-even intervals: evict long requests' KVs sooner.

``mode`` selects the regeneration path the interval prices:

* ``"kv_projection"`` — the paper's Fig. 8 measurement: layer inputs
  cached, only K/V projections replayed.
* ``"full"``          — refill-style full forward (the §3 preemption
  cost).
* ``"swap"``          — host-link transfer instead of recompute (§5.4 /
  §6 remark: the interval spectrum broadens with alternatives).  The
  per-KV swap cost is depth-independent, so swap-based intervals are
  FLAT across N — the natural price for a replacement pass over a HOST
  tier whose entries are restored by swap-in (a ROADMAP follow-up).
  The DEVICE-tier ``BreakEvenPolicy`` keeps recompute-based pricing
  even with a demotion tier below it: Eq. 5's long-prefixes-evict-
  sooner ranking is the §6 contribution under test, and a dropped or
  full host tier still regenerates by recompute.

Whatever the mode, ``interval_swap`` also reports the swap-based
interval so tables can show the whole spectrum side by side.

These intervals are not just analytics: ``policies.BreakEvenPolicy``
scores cached-prefix registry entries with them, turning Eq. 5 into the
page pool's live replacement policy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core.cost_model import CostModel


@dataclass
class BreakEven:
    n_kvs: int
    t_recom: float        # seconds to regenerate N KVs (mode-priced)
    per_kv: float         # t_recom / N
    interval: float       # break-even residency (seconds)
    interval_swap: float  # same, if regeneration is a host swap-in


def break_even_interval(model: CostModel, n_kvs: int,
                        M: int, *, mode: str = "kv_projection") -> BreakEven:
    """Eq. 5 for one request length.  ``mode`` picks the regeneration
    cost (see module docstring); unknown modes and non-positive
    ``n_kvs`` raise ``ValueError``."""
    if n_kvs <= 0:
        raise ValueError(f"n_kvs must be positive, got {n_kvs}")
    ts = model.swap_time(n_kvs)
    if mode == "kv_projection":
        t = model.kv_projection_time(n_kvs)
    elif mode == "full":
        t = model.recompute_time(n_kvs)
    elif mode == "swap":
        t = ts
    else:
        raise ValueError(f"unknown break-even mode {mode!r}")
    return BreakEven(n_kvs=n_kvs, t_recom=t, per_kv=t / n_kvs,
                     interval=t / n_kvs * M,
                     interval_swap=ts / n_kvs * M)


def break_even_table(model: CostModel, M: int,
                     ns: Sequence[int] = (1, 8, 64, 512, 4096, 32768),
                     *, mode: str = "kv_projection") -> List[BreakEven]:
    return [break_even_interval(model, n, M, mode=mode) for n in ns]
