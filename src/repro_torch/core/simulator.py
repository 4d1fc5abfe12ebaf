"""InferMax-style simulation loop (paper Fig. 1, blue boxes).

Drives the unified ``Scheduler`` (Algorithm 1) with a ``CostModel``
instead of GPUs: each batch advances virtual time by the model's predicted
batch time.  Produces the metrics of §5.1 (latency, TTFT, TPOT, TPS),
preemption counts, and per-batch logs (memory usage, batch size) used by
every multi-batch figure (9, 11, 12, 14, App. A-D).

``PrefixTierSim`` is the virtual-time shadow of the paged engine's
two-tier prefix cache (§6 replacement policy + host demotion): it runs
the SAME ``PagedAllocator`` control plane and the same ``KVSwapStore``
host-tier bookkeeping (metadata-only — no bytes move) at the same points
of the batch loop, so demotion/promotion counts and their ``swap_time``
charges match the serving engine batch-for-batch on identical schedules
(the demotion/promotion parity test pins this).

Fault parity — when ``SchedulerConfig.faults`` carries a
``serving.faults.FaultSpec``, the simulator mirrors the engine's
failure model without moving a byte: a ``_FaultMirror`` tracks which
host snapshots each suspended request would hold and draws the SAME
content-keyed verdicts from its own ``FaultPlan`` at the same decision
points.  Permanent store failures apply the engine's exact fallback
arithmetic (drop + recompute, no charge); a "corrupt" snapshot aborts
the iteration through a real step transaction (``serving.txn``) —
rollback, repair, retry — exactly as ``Engine.step`` does, so schedules
stay batch-for-batch identical under any fault schedule.  Transient
faults and their backoff are recorded but invisible to virtual time,
and attempt-keyed allocation faults are engine-internal by design (an
aborted attempt leaves no parity-visible state).  Results land in
``SimResult.recovery_stats``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import BatchSpec, CostModel
from repro_torch.core.kvcache import PagedAllocator, attach_prefix_run, chain_keys
from repro_torch.core.policies import make_replacement_policy
from repro_torch.core.request import Phase, Request
from repro_torch.core.scheduler import Batch, Scheduler, SchedulerConfig
from repro_torch.core import stat_keys as SK


@dataclass
class BatchLog:
    t_start: float
    t_end: float
    num_prefill: int
    num_decode: int
    tokens: int
    kv_used: int
    preempted: int
    swapped_out: int = 0        # victims suspended to host this batch
    swapped_in: int = 0         # suspended requests restored this batch
    swap_s: float = 0.0         # host-link time charged (in + out)
    wall_s: float = 0.0         # measured wall time (engine only; the
    #                             simulator advances virtual time and
    #                             leaves this 0)
    pages_used: int = 0         # physical pages live in the pool after
    #                             this batch (paged engine only; counts
    #                             shared pages once — the dedup signal)


@dataclass
class SimResult:
    requests: List[Request]
    batches: List[BatchLog] = field(default_factory=list)
    num_preemptions: int = 0    # full + partial (page-level) preemptions
    num_partial_preempts: int = 0
    num_swaps: int = 0
    # prefix-cache tier counters when a PrefixTierSim shadow ran
    # (promotions/demotions/charges + the shadow allocator's stats)
    prefix_stats: Dict[str, float] = field(default_factory=dict)
    # fault-mirror counters when SchedulerConfig.faults was set
    # (rollbacks, integrity failures, degraded recomputes, permanent
    # store failures, transient retries/backoff, swap fallbacks)
    recovery_stats: Dict[str, float] = field(default_factory=dict)

    # --- aggregate metrics (§5.1) -------------------------------------- #
    @property
    def makespan(self) -> float:
        return max((b.t_end for b in self.batches), default=0.0)

    @property
    def latency(self) -> float:
        """End-to-end latency: time until the LAST request finishes."""
        return max((r.finish_time or 0.0) for r in self.requests)

    @property
    def mean_latency(self) -> float:
        ls = [r.latency() for r in self.requests if r.latency() is not None]
        return sum(ls) / len(ls) if ls else 0.0

    @property
    def mean_ttft(self) -> float:
        ts = [r.ttft() for r in self.requests if r.ttft() is not None]
        return sum(ts) / len(ts) if ts else 0.0

    @property
    def max_ttft(self) -> float:
        ts = [r.ttft() for r in self.requests if r.ttft() is not None]
        return max(ts) if ts else 0.0

    @property
    def mean_tpot(self) -> float:
        ts = [r.tpot() for r in self.requests if r.tpot() is not None]
        return sum(ts) / len(ts) if ts else 0.0

    @property
    def tps(self) -> float:
        tok = sum(r.generated for r in self.requests)
        return tok / self.makespan if self.makespan else 0.0

    @property
    def mean_batch_size(self) -> float:
        bs = [b.num_prefill + b.num_decode for b in self.batches]
        return sum(bs) / len(bs) if bs else 0.0

    @property
    def mean_kv_used(self) -> float:
        ks = [b.kv_used for b in self.batches]
        return sum(ks) / len(ks) if ks else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "latency": self.latency,
            "mean_latency": self.mean_latency,
            "mean_ttft": self.mean_ttft,
            "max_ttft": self.max_ttft,
            "mean_tpot": self.mean_tpot,
            "tps": self.tps,
            "preemptions": float(self.num_preemptions),
            "swaps": float(self.num_swaps),
            "batches": float(len(self.batches)),
            "mean_batch_size": self.mean_batch_size,
            "mean_kv_used": self.mean_kv_used,
        }


def _spec_of(batch: Batch) -> BatchSpec:
    spec = BatchSpec()
    for r, c in batch.items:
        # phase *before* processing: decode iff exactly one token to go
        # and at least one token already generated.  resident_kv prices a
        # swap-resumed request against its restored context, not m=0.
        if r.generated > 0 and r.remaining_prefill == c == 1:
            spec.decodes.append((c, r.resident_kv))
        else:
            spec.prefills.append((c, r.resident_kv))
    return spec


class _FaultMirror:
    """Metadata shadow of the engine's fault handling on the suspend
    path.  Tracks, per suspended rid, the page runs the engine's swap
    store would hold — ``(num_tokens, corrupt)`` pairs, a full-slot
    snapshot being a single "run" — and draws the same content-keyed
    verdicts the engine draws (``serving.faults``), so the simulator
    degrades exactly the requests the engine degrades.  The backoff
    mirror assumes ``run_with_retries``'s default ``backoff_s=0.1``,
    which is what the engine's guarded puts use."""

    def __init__(self, plan):
        self.plan = plan
        self.runs: Dict[int, List[Tuple[int, bool]]] = {}
        self.stats: Dict[str, float] = {
            SK.ROLLBACKS: 0, SK.INTEGRITY_FAILURES: 0,
            SK.DEGRADED_RECOMPUTES: 0, SK.PERMANENT_STORE_FAILURES: 0,
            SK.TRANSIENT_RETRIES: 0, SK.BACKOFF_S: 0.0,
            SK.SWAP_FALLBACKS: 0}

    def snapshot(self):
        runs = {rid: list(rs) for rid, rs in self.runs.items()}
        stats = dict(self.stats)

        def restore() -> None:
            self.runs = {rid: list(rs) for rid, rs in runs.items()}
            self.stats = dict(stats)
        return restore

    def _transients(self, kind: str, fkey: Tuple) -> None:
        k = self.plan.transient_failures(kind, *fkey)
        if k:
            self.stats[SK.TRANSIENT_RETRIES] += k
            self.stats[SK.BACKOFF_S] += sum(0.1 * 2 ** i for i in range(k))

    def suspend(self, v: Request, sched: Scheduler) -> bool:
        """Mirror the full-suspend put (engine ``_swap_out`` /
        ``_swap_out_paged``); False = permanent failure, with the
        engine's fallback arithmetic applied (drop every stored run,
        degrade to recompute, no charge)."""
        fkey = (v.rid, v.suspended_m, v.swaps)
        if self.plan.decide("perm_put", *fkey):
            self.stats[SK.PERMANENT_STORE_FAILURES] += 1
            for _ in self.runs.pop(v.rid, []):
                v.swaps -= 1
                sched.num_swaps -= 1
                self.stats[SK.SWAP_FALLBACKS] += 1
            v.drop_suspended()
            sched.num_swaps -= 1
            self.stats[SK.SWAP_FALLBACKS] += 1
            return False
        self._transients("store_put", fkey)
        corrupt = self.plan.decide("corrupt_put", *fkey)
        self.runs.setdefault(v.rid, []).append((v.suspended_m, corrupt))
        return True

    def shed(self, r: Request, n_tokens: int, sched: Scheduler) -> bool:
        """Mirror one tail-shed put (engine ``_shed_tail``); False =
        permanent failure — the failed run AND every stored run fold
        back to recompute (the tiling has a gap)."""
        fkey = (r.rid, r.m, n_tokens, r.partial_preemptions)
        if self.plan.decide("perm_run", *fkey):
            self.stats[SK.PERMANENT_STORE_FAILURES] += 1
            r.drop_tail_run(n_tokens)
            sched.num_swaps -= 1
            self.stats[SK.SWAP_FALLBACKS] += 1
            for n, _ in self.runs.pop(r.rid, []):
                r.drop_tail_run(n)
                sched.num_swaps -= 1
                self.stats[SK.SWAP_FALLBACKS] += 1
            return False
        self._transients("store_run", fkey)
        corrupt = self.plan.decide("corrupt_run", *fkey)
        self.runs.setdefault(r.rid, []).append((n_tokens, corrupt))
        return True

    def corrupt_restore(self, batch_items) -> Optional[Request]:
        """First request in batch order whose stored snapshot is
        corrupt — the engine verifies swap-ins in batch order and
        aborts on the FIRST integrity failure."""
        for r, _ in batch_items:
            if (r.suspended or r.tail_suspended_m > 0) and \
                    any(c for _, c in self.runs.get(r.rid, [])):
                return r
        return None

    def repair(self, r: Request, sched: Scheduler) -> None:
        """Post-rollback repair, the engine's ``_drop_snapshot_repair``
        / ``_drop_runs_repair`` arithmetic: drop every stored run and
        degrade ``r`` to recompute."""
        runs = self.runs.pop(r.rid, [])
        if r.suspended:                   # full suspend (claim=True)
            for _ in runs[:-1]:           # tail runs beyond the base
                r.swaps -= 1
                sched.num_swaps -= 1
            r.drop_suspended()
            sched.num_swaps -= 1
        else:                             # tail restore (claim=False)
            for n, _ in runs:
                r.drop_tail_run(n)
                sched.num_swaps -= 1

    def restored(self, r: Request) -> None:
        """A successful swap-in empties the store for this rid."""
        self.runs.pop(r.rid, None)


class PrefixTierSim:
    """Virtual-time shadow of the paged engine's two-tier prefix cache.

    Runs the engine's EXACT control plane — the same ``PagedAllocator``
    (same replacement policy, same eviction/demotion hook) and the same
    ``KVSwapStore`` host-tier bookkeeping with metadata-only entries
    (``kv=None``; ``page_nbytes`` stands in for the real snapshot size,
    which for the engine is ``2 * L * page * Hkv * D * itemsize``) — at
    the same points of the batch loop.  Requests therefore need real
    ``prompt`` token ids.  Promotions and demotions charge
    ``cost_model.swap_time`` into the batch being priced, exactly like
    the engine, so on identical schedules the two sides agree
    batch-for-batch on counts AND on virtual time.

    Pass one to :func:`simulate`; read ``stats`` / ``alloc.stats`` (or
    ``SimResult.prefix_stats``) afterwards.  Use ``host_bytes=None``
    (unbounded) unless you replicate the engine's suspend traffic in the
    same store — the byte budget there is shared with swap entries.
    """

    def __init__(self, scfg: SchedulerConfig, cost_model: CostModel, *,
                 page_nbytes: int, host_bytes: Optional[int] = None):
        from repro_torch.serving.swap_store import KVSwapStore
        pg = scfg.page_size
        if pg <= 1:
            raise ValueError("prefix-tier shadow needs page_size > 1")
        self.pg = pg
        self.cm = cost_model
        self.demotion = bool(scfg.cache_demotion)
        self.exact = getattr(scfg, "prefix_lookup", "trie") == "exact"
        self.page_nbytes = int(page_nbytes)
        self.store = KVSwapStore(capacity_bytes=host_bytes)
        self.alloc = PagedAllocator(
            max(1, -(-scfg.M // pg)), pg,
            policy=make_replacement_policy(scfg.cache_policy,
                                           cost_model=cost_model,
                                           M=scfg.M),
            on_evict=self._demote if self.demotion else None)
        # own fault plan from the shared spec: same seed, same draws as
        # the engine's (serving.faults content-keying) — never the
        # engine's plan object, parity must not need shared state
        self.plan = None
        if getattr(scfg, "faults", None) is not None:
            from repro_torch.serving.faults import FaultPlan
            self.plan = FaultPlan(scfg.faults)
        self.pending_s = 0.0      # tier charges owed to the current batch
        self.stats: Dict[str, float] = {
            SK.PROMOTIONS: 0, SK.DEMOTIONS: 0, SK.DEMOTE_DROPS: 0,
            SK.KV_PROMOTED: 0, SK.KV_DEMOTED: 0, SK.TIER_SWAP_S: 0.0,
            SK.PREFIX_INTEGRITY: 0, SK.TRIE_HITS: 0,
            SK.PARTIAL_HIT_TOKENS: 0}
        self._keys: Dict[int, List[int]] = {}
        self._ptoks: Dict[int, List[Tuple[int, ...]]] = {}

    def snapshot(self):
        """Restore closure over the shadow's whole state (allocator,
        registry, host tier, counters) — the fault mirror's step
        transaction adds it so aborted iterations roll the shadow back
        in lockstep with the scheduler."""
        from repro_torch.serving.txn import snapshot_allocator, snapshot_store
        restore_alloc = snapshot_allocator(self.alloc)
        restore_store = snapshot_store(self.store)
        stats = dict(self.stats)
        pending = self.pending_s
        keys, ptoks = dict(self._keys), dict(self._ptoks)

        def restore() -> None:
            restore_alloc()
            restore_store()
            self.stats = dict(stats)
            self.pending_s = pending
            self._keys, self._ptoks = dict(keys), dict(ptoks)
        return restore

    def _demote(self, key: int, page: int, tokens, n_kvs: int) -> None:
        from repro_torch.serving.swap_store import SwapStoreFullError
        if self.store.has_prefix(key):
            return
        if self.plan is not None and self.plan.decide("demote_fail", key):
            # mirror of the engine's dropped demotion: no entry, no
            # charge — the page recomputes on its next miss
            self.stats[SK.DEMOTE_DROPS] += 1
            return
        try:
            self.store.put_prefix(key, tokens, n_kvs, None,
                                  nbytes=self.page_nbytes)
        except SwapStoreFullError:
            self.stats[SK.DEMOTE_DROPS] += 1
            return
        self.pending_s += self.cm.swap_time(self.pg)
        self.stats[SK.DEMOTIONS] += 1
        self.stats[SK.KV_DEMOTED] += self.pg

    def _verify(self, entry) -> bool:
        """Mirror of the engine's ``_verify_prefix`` promotion gate:
        same fault-plan draws on the same entry key (the shadow's
        entries are metadata-only, so the CRC side is trivially
        clean — rot is modeled by the ``corrupt_prefix`` flag on both
        sides, never by bytes)."""
        bad = self.plan is not None and (
            self.plan.decide("corrupt_prefix", entry.key)
            or self.plan.decide("promote_fail", entry.key))
        if bad:
            self.stats[SK.PREFIX_INTEGRITY] += 1
        return not bad

    def _chain(self, r: Request):
        keys = self._keys.get(r.rid)
        if keys is None:
            if r.prompt is None:
                raise ValueError(
                    f"prefix-tier shadow needs real prompts (rid {r.rid})")
            keys = chain_keys(r.prompt, self.pg)
            self._keys[r.rid] = keys
            self._ptoks[r.rid] = [
                tuple(r.prompt[i * self.pg:(i + 1) * self.pg])
                for i in range(len(keys))]
        return keys, self._ptoks[r.rid]

    # --- batch-loop hooks (mirror serving.engine.Engine.step) ---------- #
    def begin(self, now: float) -> None:
        self.alloc.now = now

    def preempts(self, batch: Batch) -> None:
        for r, npg, _, _ in batch.partial_preempted:
            if r.running:       # folded sheds free with the full preempt
                self.alloc.free_tail(r.rid, npg)  # repro: allow-unpriced-mutation(shadow replay of the engine shed; the scheduler already priced the preemption swap_time when it chose the victim)
        for v in batch.preempted:
            self.alloc.free(v.rid)  # repro: allow-unpriced-mutation(shadow replay of engine _release; freeing moves no bytes and the preemption was priced at victim selection)

    def swap_restores(self, swapped_in, tail_in) -> None:
        for r in swapped_in:
            self.alloc.allocate(r.rid, r.suspended_m)  # repro: allow-unpriced-mutation(shadow replay of the engine swap-in; simulate() charges swap_time for the restore in the batch price)
        for r in tail_in:
            self.alloc.allocate(r.rid, r.tail_suspended_m)  # repro: allow-unpriced-mutation(same priced restore as the full swap-in above)

    def pre_items(self, prefill_items, decode_items) -> None:
        """Claim-time control plane of the engine: prefix attach (device
        hits + host promotions), page allocation, CoW guard."""
        for r, c in prefill_items:
            skip = 0
            if r.m == 0 and not self.alloc.has(r.rid):
                skip = self._attach(r, c)
            # repro: allow-unpriced-mutation(shadow allocator bookkeeping - this batch's tokens are priced by the cost model's batch_time in simulate(), and any demotion this allocation triggers is charged by _demote)
            self.alloc.allocate(r.rid, c - skip)
            pos = r.m + skip
            if pos % self.pg:
                # repro: allow-unpriced-mutation(metadata-only copy-on-write in the shadow allocator - the engine's CoW page copy is device-local and unpriced in both engine and simulator, so pricing it here would break their parity)
                self.alloc.ensure_private(r.rid, pos // self.pg)
        for r, _ in decode_items:
            # repro: allow-unpriced-mutation(shadow allocator bookkeeping - this batch's tokens are priced by the cost model's batch_time in simulate(), and any demotion this allocation triggers is charged by _demote)
            self.alloc.allocate(r.rid, 1)
            if r.m % self.pg:
                # repro: allow-unpriced-mutation(metadata-only copy-on-write in the shadow allocator - the engine's CoW page copy is device-local and unpriced in both engine and simulator, so pricing it here would break their parity)
                self.alloc.ensure_private(r.rid, r.m // self.pg)

    def _attach(self, r: Request, c: int) -> int:
        cap = min(r.input_len - 1, c - 1) // self.pg
        if cap <= 0:
            return 0
        keys, ptoks = self._chain(r)
        attached, promoted = attach_prefix_run(
            self.alloc, r.rid, keys[:cap], ptoks[:cap],
            host_tier=self.store if self.demotion else None, restore=None,
            verify=self._verify if self.demotion else None,
            exact=self.exact)
        if promoted:
            self.pending_s += self.cm.swap_time(promoted)
            self.stats[SK.PROMOTIONS] += promoted // self.pg
            self.stats[SK.KV_PROMOTED] += promoted
        if attached:
            # mirror of the engine's trie counters (swap_stats):
            # every non-empty attach is a trie hit; anything short of
            # the full capped chain is a PARTIAL hit
            self.stats[SK.TRIE_HITS] += 1
            if attached < cap * self.pg:
                self.stats[SK.PARTIAL_HIT_TOKENS] += attached
        return attached

    def drain(self) -> float:
        """Tier charges accrued for the batch being priced."""
        s, self.pending_s = self.pending_s, 0.0
        self.stats[SK.TIER_SWAP_S] += s
        return s

    def register(self, r: Request, m_new: int) -> None:
        n = min(m_new, r.input_len) // self.pg
        if n > 0 and self.alloc.has(r.rid):
            keys, ptoks = self._chain(r)
            # repro: allow-unpriced-mutation(registration moves no bytes - mirrors the engine's annotated _register_prefix; charges accrue at demotion/promotion)
            self.alloc.register_prefix(r.rid, keys[:n], ptoks[:n])

    def on_finish(self, r: Request) -> None:
        self.alloc.free(r.rid)  # repro: allow-unpriced-mutation(completion frees pages without host traffic - mirrors the engine's annotated _release)

    def result_stats(self) -> Dict[str, float]:
        return {**self.stats, **self.alloc.stats}


def simulate(scheduler: Scheduler, requests: Sequence[Request],
             cost_model: CostModel, *, max_batches: int = 2_000_000,
             record_batches: bool = True,
             prefix_sim: Optional[PrefixTierSim] = None) -> SimResult:
    """Run the schedule to completion under virtual (cost-model) time.

    Swap-preempted victims are charged ``cost_model.swap_time`` on the
    way out and again on restore (§5.4), so simulated schedules price the
    host link exactly like the serving engine's data plane does.  An
    optional ``prefix_sim`` shadow additionally models the paged
    engine's two-tier prefix cache (policy-driven reclaim, host
    demotion, promotion) and charges its host-link traffic into each
    batch's virtual time.
    """
    if scheduler.cost_model is None:
        scheduler.cost_model = cost_model   # auto preempt-mode pricing
    # fault mirror: built from the config's spec exactly like the
    # engine's plan, so both sides draw one deterministic schedule
    mirror: Optional[_FaultMirror] = None
    if getattr(scheduler.cfg, "faults", None) is not None:
        from repro_torch.serving.faults import FaultPlan
        mirror = _FaultMirror(FaultPlan(scheduler.cfg.faults))
    pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
    now = 0.0
    result = SimResult(requests=list(requests))
    i = 0
    # charges/counts from rounds whose batch admitted no items, owed to
    # the next executed batch's log and clock
    carry_swap_s, carry_out, carry_preempted = 0.0, 0, 0

    for _ in range(max_batches):
        # admit arrivals (paper Alg. 1 line 4: fetch new requests)
        while i < len(pending) and pending[i].arrival <= now + 1e-12:
            scheduler.add_request(pending[i])
            i += 1
        if not scheduler.has_work():
            if i >= len(pending):
                break
            now = pending[i].arrival          # idle: jump to next arrival
            continue

        # step transaction (faulty runs only): snapshot AFTER admission
        # so an integrity abort rolls back to exactly this point and the
        # retried iteration re-plans from repaired state — the engine's
        # Engine.step attempt loop, in virtual time
        txn = saved = None
        if mirror is not None:
            from repro_torch.serving.txn import begin_step_txn
            txn = begin_step_txn(
                scheduler=scheduler,
                requests=scheduler.waiting + scheduler.running)
            txn.add(mirror.snapshot())
            if prefix_sim is not None:
                txn.add(prefix_sim.snapshot())
            saved = (now, carry_swap_s, carry_out, carry_preempted)

        if prefix_sim is not None:
            prefix_sim.begin(now)       # replacement-policy clock
        batch = scheduler.get_next_batch()
        if prefix_sim is not None:
            prefix_sim.preempts(batch)
        # page-level partial preemptions FIRST (engine order: tail runs
        # are snapshotted before any full suspend of the same victim):
        # swap-mode runs are charged per run (the Fig. 8 crossover
        # already priced them per run); only a RUNNING victim's shed
        # actually stores a run — a folded shed (victim also fully
        # preempted this round) charges but moves no data, so it draws
        # no fault verdicts
        for r, _, n_tokens, mode in batch.partial_preempted:
            if mode != "swap":
                continue
            if mirror is not None and r.running \
                    and not mirror.shed(r, n_tokens, scheduler):
                continue            # permanent failure: recompute
            carry_swap_s += cost_model.swap_time(n_tokens)
            carry_out += 1
        # host-link swap-out charges accrue even when the batch admits
        # nothing (the victim's transfer happens regardless); they are
        # carried into the next executed batch's virtual time.
        # swap_out_m: only the device-resident portion crosses the link
        # now (tail runs shed earlier were charged when they left)
        for v in batch.preempted:
            if not v.suspended:
                continue
            if mirror is not None and not mirror.suspend(v, scheduler):
                continue            # permanent failure: recompute
            carry_swap_s += cost_model.swap_time(v.swap_out_m)
            carry_out += 1
        carry_preempted += len(batch.preempted) + len(batch.partial_preempted)
        if not batch.items:
            if i < len(pending):              # blocked: wait for arrivals
                now = max(now, pending[i].arrival)
                continue
            raise RuntimeError(
                "scheduler deadlock: work remains but empty batch "
                f"(waiting={len(scheduler.waiting)}, "
                f"running={len(scheduler.running)})")

        spec = _spec_of(batch)
        # phase split by the engine's classification predicate (same
        # phase test _spec_of uses) — the shadow's claim-time hooks run
        # over these in the engine's order: prefills, then decodes
        pf_items = dc_items = None
        if prefix_sim is not None:
            dc_items = [(r, c) for r, c in batch.items
                        if r.generated > 0 and r.remaining_prefill == c == 1]
            pf_items = [(r, c) for r, c in batch.items
                        if not (r.generated > 0
                                and r.remaining_prefill == c == 1)]
        # integrity gate BEFORE the restores: the engine verifies every
        # snapshot at swap-in and aborts the attempt on the first
        # corrupt one — mirror that as rollback + repair + retry
        if mirror is not None:
            bad = mirror.corrupt_restore(batch.items)
            if bad is not None:
                txn.rollback()
                now, carry_swap_s, carry_out, carry_preempted = saved
                mirror.stats[SK.ROLLBACKS] += 1
                mirror.stats[SK.INTEGRITY_FAILURES] += 1
                mirror.stats[SK.DEGRADED_RECOMPUTES] += 1
                mirror.repair(bad, scheduler)   # on rolled-back state
                continue
        # swap-in charges for suspended requests re-admitted here, and
        # tail-run restores for partially-shed requests batched again
        swapped_in = [r for r, _ in batch.items if r.suspended]
        tail_in = [r for r, _ in batch.items if r.tail_suspended_m > 0]
        if prefix_sim is not None:
            prefix_sim.swap_restores(swapped_in, tail_in)
        swap_s = carry_swap_s + sum(cost_model.swap_time(r.suspended_m)
                                    for r in swapped_in) \
            + sum(cost_model.swap_time(r.tail_suspended_m) for r in tail_in)
        n_out, n_preempted = carry_out, carry_preempted
        carry_swap_s, carry_out, carry_preempted = 0.0, 0, 0
        for r in swapped_in:
            r.resume()
            if mirror is not None:
                mirror.restored(r)
        for r in tail_in:
            r.resume_tail()
            if mirror is not None:
                mirror.restored(r)
        if prefix_sim is not None:
            # claim-time control plane AFTER restore (r.m is then the
            # restored context, as the engine sees it) and BEFORE dt —
            # promotion/demotion charges belong to THIS batch
            prefix_sim.pre_items(pf_items, dc_items)
            swap_s += prefix_sim.drain()
        dt = cost_model.batch_time(spec) + swap_s
        now += dt
        pf_rids = ({r.rid for r, _ in pf_items}
                   if prefix_sim is not None else ())
        for r, c in batch.items:
            m_new = r.m + c
            r.advance(c, now)
            if prefix_sim is not None and r.rid in pf_rids:
                prefix_sim.register(r, m_new)
            if r.finished:
                scheduler.complete(r)
                if prefix_sim is not None:
                    prefix_sim.on_finish(r)
        if record_batches:
            kv_used = sum(r.m for r in scheduler.running)
            result.batches.append(BatchLog(
                t_start=now - dt, t_end=now,
                num_prefill=len(spec.prefills), num_decode=len(spec.decodes),
                tokens=spec.total_tokens, kv_used=kv_used,
                preempted=n_preempted,
                swapped_out=n_out, swapped_in=len(swapped_in) + len(tail_in),
                swap_s=swap_s))
    else:
        raise RuntimeError("simulation did not converge (max_batches hit)")

    result.num_preemptions = scheduler.num_preemptions
    result.num_partial_preempts = scheduler.num_partial_preempts
    result.num_swaps = scheduler.num_swaps
    if prefix_sim is not None:
        result.prefix_stats = prefix_sim.result_stats()
    if mirror is not None:
        result.recovery_stats = dict(mirror.stats)
    return result


# --------------------------------------------------------------------- #
# convenience: run one named scheduler over a workload
# --------------------------------------------------------------------- #

def run_sim(scheduler_name: str, requests: Sequence[Request],
            cost_model: CostModel, *, M: int, S: int = 4096,
            replacement: Optional[str] = None, ranking: str = "arrival",
            use_histogram: bool = False,
            preempt_mode: str = "recompute") -> SimResult:
    from repro_torch.core.scheduler import make_scheduler

    sched = make_scheduler(scheduler_name, M, S=S, replacement=replacement,
                           ranking=ranking, use_histogram=use_histogram,
                           preempt_mode=preempt_mode, cost_model=cost_model)
    return simulate(sched, requests, cost_model)


def fresh_requests(spec: Sequence[Tuple[int, int, float]]) -> List[Request]:
    """[(I, O, arrival)] -> new Request objects with sequential rids."""
    return [Request(rid=i, input_len=I, output_len=O, arrival=a)
            for i, (I, O, a) in enumerate(spec)]
