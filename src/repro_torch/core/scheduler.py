"""Unified scheduler — the paper's Algorithm 1.

One loop captures ORCA / vLLM / Sarathi / preemption-free variants plus the
SRF family, via four orthogonal knobs:

  priority     prefill_first | decode_first          (GROUPREQUESTS, step 1)
  hybrid       mixed prefill+decode batches?         (CHECKHYBRIDBATCHING, 2)
  chunked      crop prefill c to the token budget?   (CANALLOCATE, step 3)
  replacement  nrf | srf | lrf | pf                  (PREEMPT..., step 4)
  reserve      input | peak | context                (Table 2 "initial KV
               reserve": r.I, r.I+r.O-1 [hypothetical], or S [ORCA])

``get_next_batch`` is pure control logic over Request objects; the
simulator (cost-model time) and the serving engine (real JAX execution)
both drive it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Tuple)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.cost_model import CostModel

from repro_torch.core.histogram import OutputLengthHistogram
from repro_torch.core.invariants import invariant
from repro_torch.core.policies import group_requests, ranking_key, select_victim
from repro_torch.core.request import Phase, Request


@dataclass
class SchedulerConfig:
    M: int                       # KV cache size (tokens)
    C: int                       # token limit per batch
    S: int = 4096                # model context size (ORCA reservation)
    priority: str = "prefill_first"
    replacement: str = "nrf"     # nrf | srf | lrf | pf
    reserve: str = "input"       # input | peak | context
    hybrid: bool = False
    chunked: bool = False
    ranking: str = "arrival"     # arrival | input | output
    max_batch_requests: int = 0  # 0 = unbounded
    use_histogram: bool = False  # SRF+Hist admission gate
    # Real inference systems (vLLM v0.6.x) never evict running requests to
    # admit NEW prefills — preemption triggers only when a *running*
    # request cannot grow.  The paper's literal Algorithm-1 allows
    # admission-preemption; keep it as an opt-in knob.
    admission_can_preempt: bool = False
    max_running: int = 0         # concurrent-request cap (engine slots)
    # What happens to a victim's KVs (§5.4 recompute-vs-swap):
    #   recompute — discard; re-admission pays a full refill prefill (§3)
    #   swap      — suspend to host memory; re-admission restores them
    #               over the host link (no refill)
    #   auto      — per-victim Fig. 8 decision: swap iff the cost model's
    #               swap_time(m) undercuts its cheapest recompute path
    preempt_mode: str = "recompute"
    # Allocator granularity.  With page_size > 1 every reservation is
    # rounded UP to whole pages and the capacity is the allocator's
    # page-rounded ceil(M/page)*page, so the control plane's sum(m) <= M
    # agrees with the PagedAllocator page-for-page: OutOfPagesError is
    # unreachable on admitted schedules (internal fragmentation is
    # charged, never discovered).
    page_size: int = 1
    # Page-level partial preemption (§8 SRF pushed to sub-request
    # granularity): on memory pressure shed only the victim's TAIL pages
    # — the Fig. 8 crossover decides swap-vs-recompute per page run.
    # Requires a paged data plane (the engine enforces plane="paged").
    partial_preempt: bool = False
    # Page-pool cache replacement (§6 five-minute rule): which
    # ``policies.ReplacementPolicy`` the prefix registry evicts by —
    # "lru" | "break_even" | "belady-oracle" (offline ablation).
    # Declared HERE so control plane (simulator shadow charging) and
    # data plane (engine allocator) read one source and agree on which
    # tier every prefix lands in.
    cache_policy: str = "lru"
    # Host demotion tier: evicted prefix pages are demoted into the
    # KVSwapStore instead of discarded, and a registry hit on a
    # host-resident prefix promotes it back through the swap path,
    # charged ``cost_model.swap_time`` (virtual AND wall time).
    cache_demotion: bool = False
    # Prefix-registry lookup mode (PR 9 radix trie):
    #   trie  — radix longest-prefix walk; PARTIAL hits attach the
    #           longest cached run even when the full prompt misses
    #   exact — all-or-nothing device-only ablation (the pre-trie
    #           chained-hash behaviour): any shortfall attaches nothing
    prefix_lookup: str = "trie"
    # Deterministic fault injection (a ``serving.faults.FaultSpec``;
    # typed Any to keep core/ import-free of serving/).  Declared here
    # like page_size so the engine AND the simulator build their fault
    # plans from one source and observe the same fault schedule —
    # that is what keeps parity byte-exact under injected faults.
    faults: Optional[Any] = None


@dataclass
class Batch:
    items: List[Tuple[Request, int]] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)
    # page-level partial preemptions decided while building this batch:
    # (victim, pages shed, tokens shed, "swap" | "recompute").  The
    # victim KEEPS its slot and stays running; the driver must free /
    # snapshot exactly those tail pages.
    partial_preempted: List[Tuple[Request, int, int, str]] = \
        field(default_factory=list)

    @property
    def requests(self) -> List[Request]:
        return [r for r, _ in self.items]

    @property
    def total_tokens(self) -> int:
        return sum(c for _, c in self.items)

    def phase_items(self, phase: Phase):
        return [(r, c) for r, c in self.items if r.phase == phase]

    def __len__(self) -> int:
        return len(self.items)


class Scheduler:
    """Algorithm 1.  Owns the waiting/running queues."""

    def __init__(self, cfg: SchedulerConfig,
                 cost_model: Optional["CostModel"] = None):
        if cfg.preempt_mode not in ("recompute", "swap", "auto"):
            raise ValueError(f"preempt_mode={cfg.preempt_mode!r}")
        self.cfg = cfg
        # prices the swap-vs-recompute decision for preempt_mode="auto";
        # drivers (simulator / engine) inject theirs if unset
        self.cost_model = cost_model
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.histogram = OutputLengthHistogram() if cfg.use_histogram else None
        # stats
        self.num_preemptions = 0
        self.num_partial_preempts = 0
        self.num_swaps = 0
        self.num_batches = 0

    # ------------------------------------------------------------------ #
    def add_request(self, r: Request) -> None:
        self.waiting.append(r)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # --- memory accounting ------------------------------------------- #
    def _round_pages(self, tokens: int) -> int:
        """Round an occupancy UP to whole allocator pages (page_size=1 is
        the identity: token-exact accounting)."""
        pg = self.cfg.page_size
        if pg <= 1 or tokens <= 0:
            return max(tokens, 0)
        return -(-tokens // pg) * pg

    @property
    def M_eff(self) -> int:
        """Capacity in page-rounded tokens: ceil(M/page)*page — exactly
        ``PagedAllocator.tokens_capacity()`` for the allocator the engine
        builds, so feasibility here IS feasibility there."""
        return max(self._round_pages(self.cfg.M), self.cfg.page_size)

    def _reservation(self, r: Request, c: int = 0) -> int:
        """Page-rounded tokens of KV cache this request holds after
        processing c more.  Uses ``resident_kv``: a suspended
        (swapped-out) candidate's host KVs — full snapshot or tail page
        runs — come back on-device at restore, so they must be reserved
        for any batch that processes the request.  Idle (c=0) running
        requests reserve only what is physically on-device
        (``device_kv``): a shed tail costs nothing until restored."""
        occupied = r.device_kv if c == 0 else r.resident_kv + c
        if self.cfg.reserve == "input":
            return self._round_pages(occupied)
        if self.cfg.reserve == "peak":
            return self._round_pages(max(r.peak_kv, occupied))
        if self.cfg.reserve == "context":
            return self._round_pages(self.cfg.S)
        raise ValueError(self.cfg.reserve)

    # ------------------------------------------------------------------ #
    def get_next_batch(self) -> Batch:
        cfg = self.cfg
        batch = Batch()
        batch_tokens = 0
        batch_phase: Optional[Phase] = None
        protected = set()   # rids already in this batch — not preemptible
        preempted_now = set()

        candidates = group_requests(self.waiting, self.running,
                                    priority=cfg.priority, ranking=cfg.ranking)
        order = {r.rid: i for i, r in enumerate(candidates)}
        # incremental memory accounting: base reservation of all running
        # requests + extra reserved by items planned into this batch
        mem = sum(self._reservation(r, 0) for r in self.running)
        admitted_waiting: List[Request] = []

        for cand in candidates:
            if cand.rid in protected or cand.rid in preempted_now or cand.finished:
                continue
            if cfg.max_batch_requests and len(batch) >= cfg.max_batch_requests:
                break
            phase = (Phase.PREFILL if not cand.running else cand.phase)

            # -- slot cap (engine concurrency limit) ----------------------
            if (cfg.max_running and not cand.running
                    and len(self.running) >= cfg.max_running):
                continue

            # -- step 2: CHECKHYBRIDBATCHING ------------------------------
            if not cfg.hybrid and batch_phase is not None and phase != batch_phase:
                continue

            # -- SRF+Hist admission gate (insertion-time deferral) --------
            if (self.histogram is not None and not cand.running
                    and self._hist_defer(cand)):
                continue

            # -- step 3: CANALLOCATE --------------------------------------
            budget = cfg.C - batch_tokens
            if budget <= 0:
                break
            need = cand.remaining_prefill if phase == Phase.PREFILL else 1
            if phase == Phase.DECODE:
                c = 1
            elif cfg.chunked:
                c = min(need, budget)
            else:
                c = need
            if c <= 0 or c > budget:
                continue

            # memory delta of admitting cand with c tokens
            delta = (self._reservation(cand, c)
                     - (self._reservation(cand, 0) if cand.running else 0))

            # -- step 4: preempt lower-priority requests on memory pressure
            admitted = True
            can_preempt_others = cand.running or cfg.admission_can_preempt
            while mem + delta > self.M_eff:
                victims = ([r for r in self.running
                            if r.rid not in protected and r.rid != cand.rid
                            and order.get(r.rid, 1 << 30) > order[cand.rid]]
                           if can_preempt_others else [])
                victim = select_victim(cfg.replacement, victims)
                if (victim is not None and cfg.partial_preempt
                        and cfg.reserve == "input"):
                    # page-level partial preemption: shed only the tail
                    # pages needed to close the deficit; full preemption
                    # only when the whole victim must go.  Only the
                    # "input" reserve prices a request by its CURRENT
                    # occupancy, so only there does shedding k pages
                    # credit k*page_size back — under "peak"/"context"
                    # the reservation is m-independent and a partial
                    # shed frees nothing the accounting can see.
                    shed = self._partial_preempt(
                        victim, deficit=mem + delta - self.M_eff)
                    if shed is not None:
                        npages, n_tokens, mode = shed
                        # a shed victim is no longer admittable this
                        # round (it stays running and CAN be shed again
                        # for a later candidate — runs stack)
                        preempted_now.add(victim.rid)
                        batch.partial_preempted.append(
                            (victim, npages, n_tokens, mode))
                        mem -= npages * cfg.page_size
                        continue
                if victim is None:
                    if cand.running and cfg.replacement != "pf":
                        mem -= self._reservation(cand, 0)
                        self._preempt(cand)       # self-preemption
                        preempted_now.add(cand.rid)
                        batch.preempted.append(cand)
                    admitted = False
                    break
                mem -= self._reservation(victim, 0)
                self._preempt(victim)
                preempted_now.add(victim.rid)
                batch.preempted.append(victim)
            if not admitted:
                continue

            # -- admit ----------------------------------------------------
            if not cand.running:
                cand.running = True
                self.running.append(cand)
                admitted_waiting.append(cand)
            mem += delta
            batch.items.append((cand, c))
            batch_tokens += c
            protected.add(cand.rid)
            if batch_phase is None:
                batch_phase = phase

        if admitted_waiting:
            admitted_ids = {r.rid for r in admitted_waiting}
            self.waiting = [r for r in self.waiting if r.rid not in admitted_ids]
        self.num_batches += 1 if batch.items else 0
        return batch

    # ------------------------------------------------------------------ #
    def _hist_defer(self, cand: Request) -> bool:
        """SRF+Hist: defer admission if the predicted peak demand of
        running + cand would exceed M (avoids future preemptions)."""
        invariant(self.histogram is not None)
        pred_o = self.histogram.predict(cand.input_len)
        cand.predicted_output = pred_o
        # the candidate's demand is capped at S exactly like every running
        # request's below — a long-input candidate can never demand more
        # than one context window; page-rounded like every reservation
        demand = self._round_pages(
            min(cand.input_len + pred_o - 1, self.cfg.S))
        for r in self.running:
            ro = (r.predicted_output if r.predicted_output is not None
                  else self.histogram.predict(r.input_len))
            demand += self._round_pages(
                min(r.input_len + ro - 1, self.cfg.S))
        return demand > self.M_eff

    def _preempt(self, victim: Request) -> None:
        if victim.tail_suspended_m > 0:
            # tail runs already sit in the host store: a recompute-mode
            # full preemption would discard paid-for transfers and leave
            # swap counters/charges describing transfers that never
            # stuck — once any run is host-resident the suspend must
            # stay a swap (the store-full fallback is the driver's)
            mode = "swap"
        else:
            mode = self._mode_for(victim.m)
        victim.preempt(mode=mode)
        self.num_preemptions += 1
        if victim.suspended:
            self.num_swaps += 1
        if victim in self.running:
            self.running.remove(victim)
        self.waiting.append(victim)

    def _partial_preempt(self, victim: Request,
                         deficit: int) -> Optional[Tuple[int, int, str]]:
        """Shed only the tail pages of ``victim`` needed to close
        ``deficit`` tokens of memory pressure.  Returns (pages shed,
        tokens shed, mode) — or None when the whole victim must go
        (caller falls through to full preemption).  The kept prefix is
        whole pages, so the new boundary is page-aligned; the Fig. 8
        crossover prices THIS RUN (its token count, recompute priced
        against the kept context)."""
        pg = self.cfg.page_size
        np_v = -(-victim.m // pg) if victim.m > 0 else 0   # device pages
        k = min(-(-deficit // pg), np_v)
        if k <= 0 or k >= np_v:
            return None            # nothing to shed, or full preemption
        kept = (np_v - k) * pg
        n_tokens = victim.m - kept
        if victim.tail_suspended_m > 0:
            # runs already in the host store sit ABOVE this one: a
            # recompute-mode shed below them would leave a gap in the
            # stored tiling that no restore can bridge — contiguity
            # forces swap once any run is host-resident (auto is the
            # only mode that could mix; pure recompute never stores)
            mode = "swap"
        else:
            mode = self._mode_for(n_tokens, context=kept)
        victim.partial_preempt(n_tokens, mode=mode)
        self.num_preemptions += 1
        self.num_partial_preempts += 1
        if mode == "swap":
            self.num_swaps += 1
        return k, n_tokens, mode

    def _mode_for(self, n_tokens: int, context: int = 0) -> str:
        """Fig. 8 crossover for ``preempt_mode="auto"``: swap ``n_tokens``
        KVs iff the host-link transfer undercuts the cheapest
        recomputation path the cost model offers (K/V-projection rebuild
        or refill prefill — priced against ``context`` kept KVs for a
        tail run).  Without a cost model — or one that does not price
        swaps — auto degrades to recompute."""
        mode = self.cfg.preempt_mode
        if mode != "auto":
            return mode
        cm = self.cost_model
        if cm is None or n_tokens <= 0:
            return "recompute"
        t_swap = cm.swap_time(n_tokens)
        if t_swap <= 0.0:
            return "recompute"
        t_rec = min(cm.kv_projection_time(n_tokens),
                    cm.recompute_time(n_tokens, context=context))
        return "swap" if t_swap < t_rec else "recompute"

    # ------------------------------------------------------------------ #
    def complete(self, r: Request) -> None:
        """Called by the driver after r.advance() finished the request."""
        if r in self.running:
            self.running.remove(r)
        if self.histogram is not None:
            self.histogram.observe(r.input_len, r.output_len)


# --------------------------------------------------------------------- #
# factory for the paper's named schedulers (Tables 2 & 4)
# --------------------------------------------------------------------- #

def make_scheduler(name: str, M: int, *, S: int = 4096,
                   replacement: Optional[str] = None,
                   ranking: str = "arrival",
                   use_histogram: bool = False,
                   preempt_mode: str = "recompute",
                   page_size: int = 1,
                   partial_preempt: bool = False,
                   cache_policy: str = "lru",
                   cache_demotion: bool = False,
                   prefix_lookup: str = "trie",
                   cost_model: Optional["CostModel"] = None) -> Scheduler:
    name = name.lower()
    presets = {
        "vllm": dict(C=S, priority="prefill_first", hybrid=False, chunked=False),
        "vllm_hy": dict(C=S, priority="prefill_first", hybrid=True, chunked=False),
        "sarathi": dict(C=512, priority="decode_first", hybrid=True, chunked=True),
        "sarathi_cs": dict(C=S, priority="decode_first", hybrid=True, chunked=True),
        "sarathi_nocp": dict(C=S, priority="decode_first", hybrid=True, chunked=False),
        "sarathi_nohy": dict(C=S, priority="decode_first", hybrid=False, chunked=False),
        "orca": dict(C=S, priority="decode_first", hybrid=True, chunked=False),
    }
    base = name.removesuffix("_pf")
    if base not in presets:
        raise ValueError(f"unknown scheduler {name!r}")
    kw = dict(presets[base])
    reserve = "input"
    repl = replacement or "nrf"
    if base == "orca":
        reserve = "context"
        repl = replacement or "pf"
    if name.endswith("_pf"):
        reserve, repl = "peak", "pf"   # hypothetical *pf variants
    cfg = SchedulerConfig(M=M, S=S, reserve=reserve, replacement=repl,
                          ranking=ranking, use_histogram=use_histogram,
                          preempt_mode=preempt_mode, page_size=page_size,
                          partial_preempt=partial_preempt,
                          cache_policy=cache_policy,
                          cache_demotion=cache_demotion,
                          prefix_lookup=prefix_lookup, **kw)
    return Scheduler(cfg, cost_model=cost_model)
