"""Drive the port's serving engine against the wall clock.

The benchmark builds a ``repro_torch.serving.Engine`` on the paged plane
from the configuration file, keeps the mix's ``queue_depth`` requests
waiting (``Engine.submit``) and calls ``Engine.step`` in a loop, stamping
every new token with the host clock when the step that made it returns.
It never calls ``Engine.run``, whose clock is the cost model's virtual
time.

What a run observes goes into a ``Record``: per request its submit and
token times; per step its host interval and the pool's live pages; and,
inside the traced sub-window only, each step's decode rows and prefill
chunks, which the roofline and MFU readers price.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import traffic as T
from portbench.spec import Cell, ModelShape


def port_model_config(m: ModelShape, dtype: str):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=m.name, family=m.family, num_layers=m.num_layers,
        d_model=m.d_model, num_heads=m.num_heads,
        num_kv_heads=m.num_kv_heads, d_ff=m.d_ff, vocab_size=m.vocab_size,
        head_dim=m.head_dim, qk_norm=m.qk_norm, rope_theta=m.rope_theta,
        tie_embeddings=m.tie_embeddings, norm_eps=m.norm_eps,
        max_context=m.max_context, num_experts=m.num_experts,
        num_shared_experts=m.num_shared_experts,
        experts_per_token=m.experts_per_token, moe_d_ff=m.moe_d_ff,
        dtype=dtype, vocab_pad_multiple=m.vocab_pad_multiple,
        expert_pad_multiple=m.expert_pad_multiple)


def build_engine(cell: Cell, m: ModelShape, params, *, pool_tokens: int,
                 cache_len: int, device: str, dtype: str = "bfloat16",
                 engine: Optional[Dict] = None):
    """The warmed engine of the cell's configuration file (every step
    graph captured by ``Engine.warmup``); ``engine`` overrides some of its
    engine settings (the CPU tests' smaller grid)."""
    from repro_torch.core import (TheoreticalCostModel, get_hardware,
                                  make_scheduler)
    from repro_torch.serving import Engine, EngineConfig
    cfg = port_model_config(m, dtype)
    e = dict(cell.config["engine"], **(engine or {}))
    s = cell.config["scheduler"]
    cost = TheoreticalCostModel(cfg, get_hardware("h100"))
    sched = make_scheduler(
        s["name"], pool_tokens, S=s["S"], replacement=s["replacement"],
        preempt_mode=s["preempt_mode"], page_size=e["page_size"],
        cache_policy=e["cache_policy"], cache_demotion=e["cache_demotion"],
        prefix_lookup=e["prefix_lookup"], cost_model=cost)
    ecfg = EngineConfig(
        nslots=e["nslots"], cache_len=cache_len, chunk=e["chunk"],
        page_size=e["page_size"], plane=e["plane"], moe_impl=e["moe_impl"],
        check_invariants=e["check_invariants"],
        prefix_sharing=e["prefix_sharing"], prefix_lookup=e["prefix_lookup"],
        cache_policy=e["cache_policy"], cache_demotion=e["cache_demotion"])
    return Engine(cfg, params, sched, ecfg, cost_model=cost,
                  device=device).warmup()


def cache_len_for(mix: Dict, page: int) -> int:
    return -(-T.max_context(mix) // page) * page


@dataclass
class ReqStat:
    submit: float
    token_times: List[float] = field(default_factory=list)


@dataclass
class StepRec:
    """A step of the traced sub-window: B1's rows (context lengths, the
    new token included) and B2's rounds (per round, per prefilling row:
    (start, tokens, useful tokens, emits a token)).  ``decode_kv`` and
    ``round_kv`` count the K/V tokens of the pages the step's rows read
    before their own chunk, each physical page once however many rows
    share it."""
    decode_ctx: List[int]
    rounds: List[List[Tuple[int, int, int, bool]]]
    decode_kv: int = 0          # distinct K/V tokens B1 reads a layer
    round_kv: List[int] = field(default_factory=list)   # B2's, a round


@dataclass
class Record:
    seconds: float
    window_s: float = 0.0
    reqs: Dict[int, ReqStat] = field(default_factory=dict)
    attempted: int = 0          # submissions tried
    failed: int = 0             # submissions ``Engine.submit`` refused
    step_walls: List[float] = field(default_factory=list)
    steps: List[StepRec] = field(default_factory=list)   # sub-window only
    pool_pages: int = 0         # pages in the KV pool
    pool_peak_pages: int = 0    # most pages live after any step
    attach_mismatches: int = 0
    queue: List[Tuple[float, int, int]] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)


class TickClock:
    """A clock that advances a fixed tick per reading: a run on it does
    the same steps however fast the host is."""

    def __init__(self, tick: float):
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


class Driver:
    """One run's window: the backlog feed, the token stamps, and the
    traced sub-window's step records.  ``trace_at``: the
    second of the window at which ``tracer`` starts; it stops when the
    window closes."""

    def __init__(self, eng, reqs: List[T.Req], mix: Dict, seconds: float,
                 *, trace_at: Optional[float] = None,
                 tracer=None, clock: Callable[[], float] = time.perf_counter):
        self.eng, self.mix, self.clock = eng, mix, clock
        self.reqs = reqs
        self.rec = Record(seconds=float(seconds))
        self.trace_at, self.tracer = trace_at, tracer
        self.chunk = eng.ecfg.chunk
        self.page = eng.ecfg.page_size
        self.seen: Dict[int, int] = {}
        self.hi: Dict[int, int] = {}        # positions computed so far
        self.objs: Dict[int, object] = {}

    # --- submission ---------------------------------------------------- #
    def _submit(self, q: T.Req, now: float) -> None:
        from repro_torch.core import Request
        r = Request(rid=q.rid, input_len=len(q.prompt),
                    output_len=q.output_len, arrival=0.0,
                    prompt=q.prompt.tolist())
        self.rec.attempted += 1
        try:
            self.eng.submit(r)
        except ValueError:          # a request the engine cannot hold
            self.rec.failed += 1
            return
        self.objs[q.rid] = r
        self.seen[q.rid] = 0
        self.rec.reqs[q.rid] = ReqStat(submit=now)

    # --- one step -------------------------------------------------------- #
    def _step(self, detail: bool) -> None:
        eng, sched = self.eng, self.eng.sched
        before = list(sched.running)
        snap = {}
        regs = set()
        shared0 = eng.allocator.stats["prefix_shared_tokens"]
        if detail:
            snap = {r.rid: (r.resident_kv, r.generated) for r in before}
            snap.update({r.rid: (r.resident_kv, r.generated)
                         for r in sched.waiting if r.suspended})
            if eng.ecfg.prefix_sharing:
                regs = set(eng.allocator.prefix_cache.pages)
        t0 = self.clock()
        with self._annotate("portbench.engine_step"):
            eng.step()
        t1 = self.clock()
        self.rec.step_walls.append(t1 - t0)
        self.rec.pool_peak_pages = max(self.rec.pool_peak_pages,
                                       eng.allocator.used_pages)
        watch = {r.rid: r for r in before}
        watch.update({r.rid: r for r in sched.running})
        gen_before = {rid: self.seen.get(rid, 0) for rid in watch}
        for rid, r in watch.items():
            st = self.rec.reqs.get(rid)
            if st is None:
                continue
            n = len(eng.outputs[rid])
            if n > self.seen[rid]:
                st.token_times.extend([t1] * (n - self.seen[rid]))
                self.seen[rid] = n
        if detail:
            self.rec.steps.append(self._step_rows(
                watch, snap, gen_before, regs,
                eng.allocator.stats["prefix_shared_tokens"] - shared0))

    def _step_rows(self, watch, snap, gen_before, regs, shared) -> StepRec:
        """Reconstruct the step's B1 rows and B2 chunks from the requests'
        progress (no hook into the engine)."""
        decode_ctx: List[int] = []
        decode_pages: Dict[int, int] = {}
        rows: List[Tuple[int, int, int, int, bool]] = []
        fresh: List[Tuple[int, int, int]] = []
        for rid, r in watch.items():
            res_b, gen_b = snap.get(rid, (0, gen_before[rid]))
            target_b = r.input_len + gen_b
            c = target_b - res_b if r.finished else r.m - res_b
            if c <= 0:
                continue                    # preempted, or not scheduled
            emits = r.generated > gen_b
            if gen_b >= 1 and c == 1 and target_b - res_b == 1:
                decode_ctx.append(res_b + 1)
                self._read(decode_pages, rid, res_b + 1)
                self.hi[rid] = max(self.hi.get(rid, 0), res_b + 1)
                continue
            skip = 0
            if res_b == 0 and self.eng.ecfg.prefix_sharing \
                    and self.eng.allocator.has(rid):
                pages = self.eng.allocator.table(rid).pages
                cap = min(r.input_len - 1, c - 1) // self.page
                while skip < cap and pages[skip] in regs:
                    skip += 1
                fresh.append((len(rows), cap, skip))
                skip *= self.page
            rows.append([rid, res_b, c, skip, emits])
        got = sum(s for _, _, s in fresh) * self.page
        if got != shared:               # an evicted page reused in place
            self.rec.attach_mismatches += 1
            left = shared
            for i, cap, _ in fresh:
                rows[i][3] = min(cap * self.page, left)
                left -= rows[i][3]
        rounds: List[List[Tuple[int, int, int, bool]]] = []
        round_pages: List[Dict[int, int]] = []
        for rid, res_b, c, skip, emits in rows:
            pos, end = res_b + skip, res_b + c
            k = 0
            while pos < end:
                n = min(self.chunk, end - pos)
                useful = max(0, pos + n - max(pos, self.hi.get(rid, 0)))
                if k == len(rounds):
                    rounds.append([])
                    round_pages.append({})
                rounds[k].append((pos, n, useful, emits and pos + n == end))
                self._read(round_pages[k], rid, pos)
                pos += n
                k += 1
            self.hi[rid] = max(self.hi.get(rid, 0), end)
        return StepRec(decode_ctx, rounds,
                       sum(decode_pages.values()),
                       [sum(p.values()) for p in round_pages])

    def _read(self, pages: Dict[int, int], rid: int, n: int) -> None:
        """Note the first ``n`` K/V tokens of ``rid`` in ``pages`` (physical
        page -> tokens read in it); a request whose table is already gone
        (it finished) counts under a key of its own."""
        alloc, pg = self.eng.allocator, self.page
        if not alloc.has(rid):
            pages[-1 - rid] = n
            return
        table = alloc.table(rid).pages
        for i in range(-(-n // pg)):
            p = table[i]
            pages[p] = max(pages.get(p, 0), min(pg, n - i * pg))

    def _annotate(self, name: str):
        if self.tracer is None:
            return nullcontext()
        return torch.profiler.record_function(name)

    # --- the window -------------------------------------------------------- #
    def run(self) -> Record:
        eng, rec = self.eng, self.rec
        rec.pool_pages = eng.allocator.num_pages
        depth = int(self.mix["queue_depth"])
        seconds = rec.seconds
        i, traced = 0, False
        next_sample = 1.0
        t_start = self.clock()
        now = 0.0
        while now < seconds:
            with self._annotate("portbench.submit"):
                while i < len(self.reqs) and len(eng.sched.waiting) < depth:
                    self._submit(self.reqs[i], now)
                    i += 1
            if self.trace_at is not None and not traced \
                    and now >= self.trace_at:
                self.tracer.start()
                traced = True
            if not eng.sched.has_work():
                raise RuntimeError("the backlog drained inside the window")
            self._step(traced)
            now = self.clock() - t_start
            if now >= next_sample:
                rec.queue.append((round(now, 3), len(eng.sched.waiting),
                                  len(eng.sched.running)))
                next_sample += 1.0
        if traced:                  # the profiler's stop collects the trace
            self.tracer.stop()      # and takes seconds: after the window
        rec.window_s = now
        # token stamps are kept relative to the window
        for st in rec.reqs.values():
            st.token_times = [t - t_start for t in st.token_times]
        rec.counters = {
            "preemptions": eng.sched.num_preemptions,
            "swaps": eng.sched.num_swaps,
            "prefill_rounds": eng.prefill_rounds,
            "decode_steps": eng.decode_steps,
            "steps": len(rec.step_walls),
            "reclaimed": eng.allocator.stats["reclaimed"],
            "prefix_hits": eng.allocator.stats["prefix_hits"]}
        return rec

    def finished(self) -> Dict[int, Tuple[np.ndarray, List[int]]]:
        """rid -> (prompt, served tokens) of every request that finished in
        the window."""
        out = {}
        by_rid = {q.rid: q for q in self.reqs}
        for rid, r in self.objs.items():
            if r.finished:
                out[rid] = (by_rid[rid].prompt, list(self.eng.outputs[rid]))
        return out
