"""Canonical counter-key constants for the engine<->simulator mirror.

The paper's validation methodology (and every parity test in this repo)
hinges on the serving engine and the virtual-time simulator reporting
the SAME counters for the same traffic: ``Engine.swap_stats`` /
``Engine.recovery_stats`` on one side, ``PrefixTierSim.stats`` /
``_FaultMirror.stats`` on the other.  Those dicts used to be keyed by
string literals typed independently at ~80 sites — a typo'd or
one-sided key silently created parity drift that only a runtime test on
the right workload could catch.

This module is the single source for those keys.  Both sides key their
stat dicts through these constants, and the ``stat-mirror`` static
checker (``repro.analysis.statmirror``) parses THIS file for the two
sanctioned-asymmetry sets below, then cross-checks every key written on
either side: an engine-only or sim-only key outside its allowlist is a
blocking finding before any parity test runs.

Keys are grouped by which side may write them:

* mirrored keys must be written on BOTH sides (engine dict and its
  simulator shadow);
* ``ENGINE_ONLY_KEYS`` are measured wall-clock or engine-internal
  counters the simulator cannot see by construction;
* ``SIM_ONLY_KEYS`` is virtual time the engine accounts elsewhere.
"""
from __future__ import annotations

# --------------------------------------------------------------------- #
# swap traffic (engine swap_stats; no simulator shadow by design — the
# simulator prices swaps into virtual time but does not count transfers
# it never performs; BatchLog.swapped_out/in carry the parity signal)
# --------------------------------------------------------------------- #
SWAP_OUTS = "swap_outs"
SWAP_INS = "swap_ins"
KV_OUT = "kv_out"
KV_IN = "kv_in"
DRAINS_ON_SWAPIN = "drains_on_swapin"
WALL_OUT_S = "wall_out_s"
WALL_IN_S = "wall_in_s"

# --------------------------------------------------------------------- #
# prefix-tier traffic (engine swap_stats <-> PrefixTierSim.stats)
# --------------------------------------------------------------------- #
PROMOTIONS = "promotions"
DEMOTIONS = "demotions"
DEMOTE_DROPS = "demote_drops"
KV_PROMOTED = "kv_promoted"
KV_DEMOTED = "kv_demoted"
PREFIX_INTEGRITY = "prefix_integrity"
TRIE_HITS = "trie_hits"
PARTIAL_HIT_TOKENS = "partial_hit_tokens"
WALL_PROMOTE_S = "wall_promote_s"      # engine wall measurement
WALL_DEMOTE_S = "wall_demote_s"        # engine wall measurement
TIER_SWAP_S = "tier_swap_s"            # sim virtual time (engine folds
#                                        the same charge into batch dt)

# --------------------------------------------------------------------- #
# fault handling (engine swap_stats/recovery_stats <-> _FaultMirror)
# --------------------------------------------------------------------- #
PERMANENT_STORE_FAILURES = "permanent_store_failures"
TRANSIENT_RETRIES = "transient_retries"
BACKOFF_S = "backoff_s"
SWAP_FALLBACKS = "swap_fallbacks"
ROLLBACKS = "rollbacks"
INTEGRITY_FAILURES = "integrity_failures"
DEGRADED_RECOMPUTES = "degraded_recomputes"
ALLOC_FAULTS = "alloc_faults"          # attempt-keyed, engine-internal
STRAGGLER_REQUEUES = "straggler_requeues"  # wall-triggered, engine-only
WALL_ABORTED_S = "wall_aborted_s"      # engine wall measurement

# --------------------------------------------------------------------- #
# wall-clock phase attribution of the pooled step (engine phase_stats;
# pure measurement, no simulator analogue)
# --------------------------------------------------------------------- #
ATTACH_S = "attach_s"
PREFILL_S = "prefill_s"
UPLOAD_S = "upload_s"

# --------------------------------------------------------------------- #
# PagedAllocator.stats — the control plane is the SAME class on both
# sides (the shadow runs a real allocator), so these cannot drift; the
# constants exist so call sites stay typo-proof
# --------------------------------------------------------------------- #
PREFIX_HITS = "prefix_hits"
PREFIX_SHARED_TOKENS = "prefix_shared_tokens"
COW_COPIES = "cow_copies"
RECLAIMED = "reclaimed"
RECLAIM_SKIPPED = "reclaim_skipped"

# --------------------------------------------------------------------- #
# sanctioned asymmetries — parsed by ``repro.analysis.statmirror``.
# Every entry documents WHY the other side cannot mirror it; a key
# written on one side only and absent here is parity drift.
# --------------------------------------------------------------------- #

#: measured wall-clock or engine-internal counters: the simulator moves
#: no bytes (wall_*), never retries an attempt (alloc_faults — aborted
#: attempts leave no parity-visible state), and has no real clock to
#: blow a straggler deadline (straggler_requeues, wall_aborted_s).
#: swap transfer counts ride BatchLog.swapped_out/in on the sim side.
ENGINE_ONLY_KEYS = frozenset({
    SWAP_OUTS, SWAP_INS, KV_OUT, KV_IN, DRAINS_ON_SWAPIN,
    WALL_OUT_S, WALL_IN_S, WALL_PROMOTE_S, WALL_DEMOTE_S,
    ALLOC_FAULTS, STRAGGLER_REQUEUES, WALL_ABORTED_S,
})

#: the tier shadow accumulates its swap_time charges under one key; the
#: engine folds the identical charges into the batch dt via
#: ``_tier_swap_s`` (a scalar, not a stats key) — parity compares the
#: resulting BatchLog.swap_s, not this counter.
SIM_ONLY_KEYS = frozenset({TIER_SWAP_S})

#: BatchLog fields only the engine populates: measured wall time and
#: physical pool occupancy (the simulator advances virtual time and
#: owns no pools).  Parsed by ``statmirror`` alongside the key sets.
ENGINE_ONLY_BATCHLOG_FIELDS = frozenset({"wall_s", "pages_used"})
