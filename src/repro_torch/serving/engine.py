"""Continuous-batching serving engine on PyTorch — the paper's deployment
path (Fig. 1) with the paged data plane on hand-written CUDA kernels, the
slot-resident planes for every family (dense, MoE, the VLM and audio
families, RWKV6 and the hybrid family), and the legacy plane.

The engine drives the unified ``Scheduler`` (Algorithm 1) against the
real model.  Memory accounting (the scheduler's M) is backed by a
``PagedAllocator`` at page granularity: the scheduler charges
page-rounded occupancy against the allocator's page-rounded capacity
(``ceil(M/page_size)`` pages), so a schedule the control plane admits is
allocator-feasible by construction.

Data planes.  ``plane="paged"`` on the families with unbounded dense
attention (dense, MoE, ``vlm`` and ``audio``: the pooled plane; their
requests are text or codec tokens alone, with no image prefix, as in the
JAX engine):
attention KV lives in shared per-layer page pools (``serving.paged_plane``);
prefill writes K/V through the block table into owned pages with the
fused paged-prefill kernel, and decode appends one row per slot and runs
the paged flash-decoding kernel.  On top of the pooled pages:

* *shared-prefix reuse* (``prefix_sharing``, on by default; off: no
  attach, no registration, no demotion) — full prompt pages are published
  to the radix-trie prefix registry; a new request whose prompt matches
  maps the SAME physical pages (longest run, partial hits included; or all-or-nothing
  under ``prefix_lookup="exact"``) and skips their prefill compute.  A
  copy-on-write guard makes a shared page private before any in-page
  append.  Registry pages are reclaimed in the order of the pluggable
  replacement policy (``cache_policy``: ``lru`` or ``break_even``).
* *bucket ladder + packed prefill grid* — every prefill sub-chunk is
  padded up to a fixed ladder of bucket sizes, and a round's prefilling
  rows are packed into the smallest row rung (powers of eight below
  ``nslots``, then ``nslots``) of a ``(rows, bucket+3)`` int32 grid
  [toks | lens | starts | slot], ONE upload; each row reads its slot's
  block table.  A round of one prompt computes one row, not ``nslots``.
* *dirty-row block-table mirror* — a persistent host copy of the block
  tables is rewritten row by row from the allocator's dirty set and
  uploaded once per change.
* *device-resident decode cohort* — while the set of decoding requests
  is unchanged, a decode step's inputs are what the previous step wrote
  into the decode graph's own input buffer: nothing is uploaded.

The slot-resident plane (``plane="batched"``, and ``plane="paged"`` on a
family whose state is not worth paging, as in the JAX engine: RWKV6's is
O(1) per request, and so is a sliding window's, whose ring holds at most
``window`` K/V): every slot's state -- the dense family's contiguous K/V
rows (``index``, ``k``, ``v``), RWKV6's recurrent state, the hybrid
family's K/V ring beside its SSM state (``h`` fp32, ``conv``) -- lives
in one cache of ``models.model.init_cache(cfg, nslots, cache_len)``.
Under a window the engine clamps ``chunk`` to it on its own copy of the
``EngineConfig``, as JAX does (a chunk may not lap its own ring).  A
prefill round is ONE ``prefill_chunk`` call over ``(nslots, bucket)``
tokens and ``(nslots,)`` lengths (the WKV6 kernel runs once per layer on
RWKV6), a decode step one decode over all slots; each merges its new
state into the active rows only, and a claimed slot's state is zeroed
first.  ``EngineConfig.impl`` picks the dense decode's attention
(``"paged"``: the paged decode kernel on the contiguous cache viewed as
64-token pages), and ``decode_append="deferred"`` writes a step's new
K/V with one scatter after the layer loop.  The allocator still keeps
the page-rounded control plane (the scheduler's M); prefix sharing,
which maps KV pages, runs on the pooled plane only.

The legacy plane (``plane="legacy"``, the JAX engine's first plane, kept
as the baseline of ``benchmarks/fig_engine_wall.py``): the same slot
cache, but each request's prefill is an exact-shape chunk loop on its
own slot (``prefill_chunk`` with no ``length`` on a one-slot gather,
written back into the same leaves).  Its decode is the slot plane's.

Preemption follows ``SchedulerConfig.preempt_mode``, as in the JAX
engine: ``recompute`` frees a victim's pages (or slot) and its
re-admission pays a full refill prefill (§3); ``swap`` snapshots them to
the host ``KVSwapStore`` (every cache leaf of a slot; a run of pool
pages on the pooled plane) and restores them on re-admission with no
refill; ``auto`` picks per victim from the cost model's Fig. 8
crossover.  On the pooled plane ``partial_preempt`` sheds only a
victim's tail pages (§8), and ``cache_demotion`` snapshots evicted
prefix pages to the store's host tier, from which a later registry hit
promotes them back (§6).  Every host transfer is asynchronous on a card
(``serving.host_copy``: fresh device gathers, pinned host buffers, one
copy stream, CUDA events) and finalized at the JAX engine's drain
boundaries; ``async_swap=False`` is the synchronous path.  Virtual time
charges ``cost_model.swap_time`` exactly as the JAX engine does.
Sampling is fused on the device; only ``(nslots,)`` int32 ids reach the
host each step.

Failure model, as in the JAX engine: every scheduler batch is a step
transaction (``serving.txn``, a word-for-word copy).  Faults are drawn
from a seeded ``serving.faults.FaultPlan`` (``EngineConfig.faults``,
written through to the SchedulerConfig) and handled on the same
three-rung ladder: transient store puts retry with a virtual backoff;
an injected allocation fault (``FaultError``) rolls the attempt back and
the step retries; a host snapshot whose CRC seal fails at swap-in
(``IntegrityError``) rolls back, its entry is dropped and its request
degrades to recompute.  ``recovery_stats`` records the aborts outside the
transaction, and ``straggler_factor`` arms the ``StragglerMonitor``.

Differences from the JAX engine (``repro.serving.engine``):

* Device state and the commit point.  JAX rolls its cache and pools back
  by restoring references to immutable arrays; the port writes them in
  place.  Every fault point of an attempt (the allocator's fault hook,
  the swap-in seal checks, ``OutOfPagesError``) comes before compute, and
  so do five kinds of device write: a claimed slot's reset, a slot
  swap-in, a page-run restore (full or tail), a prefix promotion and a
  copy-on-write page copy.  Inside an attempt each of them is an intent
  (``_write``): host bytes are copied at once into fresh device staging
  buffers, but the pools and the slots are written only at one commit
  point (``_commit``), after the claim-and-allocate loop and before the
  prefill rounds, where the intents are applied in order.  No fault
  point follows the commit (a fault hook or a seal failure after it is
  an invariant violation), and a rolled-back attempt drops its intents,
  so every page and slot keeps its batch-start bytes.  The gathers that
  read the pools before the commit (swap-outs, tail sheds, demotions)
  read pages no intent of the same attempt targets, which is checked.
* Compiled steps are CUDA graphs (``serving.step_graphs``).  Where the
  JAX engine jits each plane step, the port captures one graph per step
  shape: one prefill round per (row rung, ladder bucket) -- a slot plane
  has the one rung ``nslots`` -- and one decode step, on every plane,
  sharing one memory pool.  On a card every prefill round
  and decode step after a graph's first call is one ``replay()``; the
  step reads static input buffers the engine uploads into (the packed
  round grid, the decode cohort, the block tables) and writes the pools
  or the cache leaves in place.  ``warmup()`` captures every graph the
  run loop can hit, as JAX's compiles every signature; a shape warmup
  missed is captured at first use.  ``num_graphs`` counts the graphs
  built (the same count on the CPU, where each call runs the same
  function eagerly over the same buffers) and stays a small constant
  during ``run``; ``num_compiles`` is 0, as nothing is traced or compiled
  per signature (the CUDA kernels are built once per source).  The
  legacy plane's prefill is the exception: it runs eagerly, as its exact
  shapes (one JAX compile per tail length) are the point of the plane,
  and only its decode step is a graph.
* Over a device mesh (``distributed.context.set_mesh``) the JAX engine's
  steps are one GSPMD program from one controller; the port runs the
  same engine on every rank (``serving.spmd``).  ``impl="seqsharded"``
  on the slot planes shards the cache's ``k``/``v`` over the sequence,
  ``moe_impl="ep"`` the experts; every other tensor is plain and equal
  on every rank.  The step's wall is agreed (its max over the mesh)
  before the straggler monitor reads it, and under ``check_invariants``
  each step's greedy tokens are checked equal across ranks.  Steps run
  eagerly there (``num_graphs`` is 0): their collectives run on the host
  under ``gloo`` and cannot be captured.  Without a mesh both settings
  raise ``ValueError`` at construction, where JAX's model functions
  raise at the first step.
  ``EngineConfig`` has no ``share_jits``: a step graph belongs to the
  engine that captured it.
* The step's phases are spans (``serving.spans``): ``engine.step`` and
  inside it ``engine.schedule``, ``engine.preempt``, ``engine.swap_in``,
  ``engine.attach``, ``engine.commit``, ``engine.prefill`` (its
  ``engine.round``s), ``engine.decode``, ``engine.account`` and
  ``engine.drain``; ``engine.block_tables``, ``engine.upload``,
  ``engine.replay`` and ``engine.fetch`` inside the compute phases.
  Each adds its host seconds to ``phase_stats`` and, while a
  ``torch.profiler`` collects, is a range on the profiler's clock.
  ``prefill_tokens`` / ``prefill_grid_tokens`` count the rounds' real
  tokens and the padded grid they compute; ``prefill_rounds_by_rows``
  the rounds by their grid's rows.

Correctness contract (tested against the JAX engine on the CPU, and
against ``generate_reference`` on the card): scheduling, chunking,
batching, padding, prefix sharing and preemption never change the
generated tokens, and the ``BatchLog`` schedule is the JAX engine's.
The allocator's invariants are checked after every step.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import BatchSpec, CostModel
from repro_torch.core.invariants import invariant
from repro_torch.core.kvcache import (OutOfPagesError, PagedAllocator,
                                      attach_prefix_run, chain_keys)
from repro_torch.core.policies import make_replacement_policy
from repro_torch.core.request import Request
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.simulator import BatchLog, SimResult
from repro_torch.core import stat_keys as SK
from repro_torch.distributed.context import get_mesh
from repro_torch.distributed.fault_tolerance import (StragglerMonitor,
                                                     run_with_retries)
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.serving.faults import (FaultError, FaultPlan,
                                        IntegrityError, PermanentStoreError,
                                        TransientStoreError)
from repro_torch.serving import spmd
from repro_torch.serving import spans
from repro_torch.serving.spans import span
from repro_torch.serving.host_copy import (HostLink, Transfer, gather_pages,
                                           gather_slot, nbytes_of,
                                           restore_pages, restore_slot)
from repro_torch.serving.paged_plane import (build_paged_fns,
                                             decode_and_advance, init_pools,
                                             paged_supported)
from repro_torch.serving.serve_step import (build_decode_fn,
                                            build_prefill_chunk_fn)
from repro_torch.serving.spmd import merge_rows  # noqa: F401  (re-export)
from repro_torch.serving.swap_store import (KVSwapStore, SwapEntry,
                                            SwapStoreFullError, flip_bit,
                                            seal_entry, verify_entry)
from repro_torch.serving.step_graphs import (StepGraph, StepGraphs,
                                             collector_held)
from repro_torch.serving.txn import StepTxn, begin_step_txn

# hard ceiling on fault-recovery retries of one step (the JAX engine's):
# content-keyed draws are idempotent, so only attempt-keyed allocation
# faults can chain, and 50 in a row means the fault plan is broken
_MAX_STEP_ATTEMPTS = 50


@dataclass
class EngineConfig:
    """The JAX engine's ``EngineConfig``: the same fields and defaults,
    save ``share_jits``, which has no counterpart here -- a step graph
    captures one engine's static buffers and pool, so graphs are never
    shared between engines."""
    nslots: int = 8
    cache_len: int = 256          # per-request context capacity (tokens)
    chunk: int = 64               # chunked-prefill chunk size
    page_size: int = 1            # allocator granularity (1 = token-exact,
    #                               matching the scheduler's M accounting)
    #                               = the KV page size on the pooled plane
    impl: str = "reference"       # the slot planes' dense decode
    #                               attention: "reference", "paged" (the
    #                               paged decode kernel on the contiguous
    #                               cache), "flash_jnp", "seqsharded" (the
    #                               cache's sequence sharded over the
    #                               mesh's "model" axis; needs set_mesh)
    moe_impl: str = "dense"       # MoE dispatch: "dense" (chunk-invariant,
    #                               for parity), "sparse" (capacity
    #                               buffers), "ep" (experts sharded over
    #                               the mesh's "model" axis; needs set_mesh)
    #                               or "grouped" (dropless, each expert
    #                               over its own rows; chunk-invariant)
    swap_bytes: Optional[int] = None   # host swap-store capacity (None =
    #                                    unbounded); a full store makes the
    #                                    victim fall back to recompute
    check_invariants: bool = True  # the allocator, swap-store and index
    #                               checks after every step and run
    plane: str = "batched"        # "batched": slot-resident, bucketed
    #                               rounds; "paged": pooled KV pages
    #                               (dense attention) or slot-resident
    #                               state (RWKV6); "legacy": slot-resident,
    #                               per-request exact-shape prefill
    prefix_sharing: bool = True   # pooled plane: map identical full
    #                               prompt pages to the same physical
    #                               pages via the refcounted registry
    prefix_lookup: Optional[str] = None  # "trie" | "exact"; None keeps
    #                               the SchedulerConfig's choice, set it is
    #                               written through (like page_size)
    cache_policy: Optional[str] = None   # "lru" | "break_even"; None
    #                               keeps the SchedulerConfig's choice
    cache_demotion: Optional[bool] = None  # evicted prefix pages demote
    #                               to the host KVSwapStore instead of
    #                               being discarded (pooled plane only);
    #                               None keeps the SchedulerConfig's choice
    decode_append: str = "inline"  # "inline" | "deferred" (one cache
    #                               scatter per step; slot planes)
    async_swap: bool = True       # host copies on the copy stream, drained
    #                               at step boundaries; False: synchronous
    min_bucket: int = 8           # smallest tail bucket of the ladder
    faults: Optional[Any] = None  # a serving.faults.FaultSpec, written
    #                               through to SchedulerConfig.faults so
    #                               the engine and any simulator shadow
    #                               draw one fault schedule
    straggler_factor: Optional[float] = None  # arm StragglerMonitor: a
    #                               step whose measured wall exceeds factor
    #                               x the cost model's dt requeues every
    #                               running request (wall-clock dependent)


def _bucket_ladder(chunk: int, min_bucket: int) -> List[int]:
    """Fixed padding targets: powers of two in [min_bucket, chunk), plus
    ``chunk`` itself.  Every prefill sub-chunk is padded UP to the
    smallest bucket that holds it."""
    b = 1
    while b < min(min_bucket, chunk):
        b *= 2
    ladder = []
    while b < chunk:
        ladder.append(b)
        b *= 2
    ladder.append(chunk)
    return ladder


def _row_rungs(nslots: int) -> List[int]:
    """Row counts of the pooled plane's prefill grids: powers of eight
    below ``nslots``, plus ``nslots`` itself.  A round's prefilling rows
    are packed into the smallest rung that holds them.  Each rung costs
    one graph capture per bucket in set-up (0.1-0.2 s each on an H100's
    host), and a round seldom holds more than one row once the slots are
    full, so the rungs are sparse: at 32 slots, 1, 8 and 32."""
    rungs = []
    r = 1
    while r < nslots:
        rungs.append(r)
        r *= 8
    rungs.append(nslots)
    return rungs


def _first_layer(params: Any) -> Any:
    """``params`` with every stacked per-layer leaf cut to its first layer
    (views)."""
    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:1]
                for k, v in tree.items()}
    return {**params, "layers": cut(params["layers"])}


def _validate(cfg: ModelConfig, ecfg: EngineConfig,
              scheduler: Scheduler, mesh) -> None:
    """Refuse every setting this port does not run, and the mesh-only
    settings without a mesh."""
    scfg = scheduler.cfg
    if ecfg.plane not in ("batched", "legacy", "paged"):
        raise ValueError(f"unknown plane {ecfg.plane!r}")
    if ecfg.decode_append not in ("inline", "deferred"):
        raise ValueError(f"unknown decode_append {ecfg.decode_append!r}")
    M.check_supported(cfg)
    if ecfg.moe_impl not in moe_mod.DISPATCH:
        raise ValueError(f"unknown moe_impl {ecfg.moe_impl!r}")
    if mesh is None and ecfg.moe_impl == "ep" and cfg.num_experts:
        raise ValueError("moe_impl 'ep' shards the experts over a device "
                         "mesh: call distributed.context.set_mesh(mesh) "
                         "first")
    if mesh is None and _seqsharded(cfg, ecfg):
        raise ValueError("impl 'seqsharded' shards the cache's sequence "
                         "over a device mesh: call distributed.context."
                         "set_mesh(mesh) first")
    if scfg.partial_preempt and not (ecfg.plane == "paged"
                                     and paged_supported(cfg)):
        raise ValueError("partial_preempt needs the pooled paged data plane")
    if scfg.cache_policy not in ("lru", "break_even"):
        raise ValueError(f"cache_policy {scfg.cache_policy!r}: this port "
                         "serves 'lru' and 'break_even'")
    if scfg.prefix_lookup not in ("trie", "exact"):
        raise ValueError(f"unknown prefix_lookup {scfg.prefix_lookup!r}")


def _seqsharded(cfg: ModelConfig, ecfg: EngineConfig) -> bool:
    """Whether the decode attention runs on a sequence-sharded cache: a
    slot plane's attention family (on the pooled plane ``impl`` picks
    nothing, RWKV6 has no attention)."""
    return (ecfg.impl == "seqsharded" and cfg.family != "ssm"
            and not (ecfg.plane == "paged" and paged_supported(cfg)))


class Engine:
    def __init__(self, cfg: ModelConfig, params: Any, scheduler: Scheduler,
                 ecfg: Optional[EngineConfig] = None,
                 cost_model: Optional[CostModel] = None, *,
                 device: str = "cuda"):
        # copy the config: a shared default (or caller-reused) instance
        # must not be mutated by the per-model chunk clamp below
        ecfg = replace(ecfg) if ecfg is not None else EngineConfig()
        if cfg.window:
            ecfg.chunk = min(ecfg.chunk, cfg.window)
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = torch.device(device)
        self.params = params
        self.sched = scheduler
        self.cost_model = cost_model
        if scheduler.cost_model is None:
            scheduler.cost_model = cost_model
        scheduler.cfg.max_running = ecfg.nslots
        # page-rounded capacity on both sides (ceil, not floor): the
        # scheduler is told the granularity so both round identically
        scheduler.cfg.page_size = ecfg.page_size
        # EngineConfig overrides are written through to the scheduler so
        # the control plane and this data plane agree on one policy
        if ecfg.cache_policy is not None:
            scheduler.cfg.cache_policy = ecfg.cache_policy
        if ecfg.prefix_lookup is not None:
            scheduler.cfg.prefix_lookup = ecfg.prefix_lookup
        if ecfg.cache_demotion is not None:
            scheduler.cfg.cache_demotion = ecfg.cache_demotion
        if ecfg.faults is not None:
            scheduler.cfg.faults = ecfg.faults
        # SPMD over the ambient mesh when one is set (``serving.spmd``)
        self.mesh = get_mesh()
        _validate(cfg, ecfg, scheduler, self.mesh)
        # pooled paged plane for unbounded dense attention; the bounded
        # state of RWKV6 stays slot-resident (and keeps no host tier)
        self._pooled = ecfg.plane == "paged" and paged_supported(cfg)
        self._legacy = ecfg.plane == "legacy"
        self._demotion = bool(scheduler.cfg.cache_demotion) \
            and self._pooled and ecfg.prefix_sharing
        self.allocator = PagedAllocator(
            num_pages=max(1, -(-scheduler.cfg.M // ecfg.page_size)),
            page_size=ecfg.page_size,
            policy=make_replacement_policy(scheduler.cfg.cache_policy,
                                           cost_model=cost_model,
                                           M=scheduler.cfg.M),
            on_evict=self._demote_prefix if self._demotion else None)
        pg = ecfg.page_size
        self.max_pages = -(-ecfg.cache_len // pg)
        if self.mesh is not None and ecfg.moe_impl == "ep" \
                and cfg.num_experts:
            spmd.check_split(cfg.padded_experts, "moe_impl='ep': experts",
                             self.mesh, "model")
            self.params = spmd.place_experts(cfg, params, self.mesh)
        # the grouped MoE dispatch's row accumulators on the device, one
        # row a layer: [routed rows by expert | calls that reached the
        # expert | min(experts, routed rows) a call | spare, for 16-byte
        # rows]; the step graphs add to them and nothing reads them
        # before the run ends (``kernels.moe_grouped.ops.row_counters``)
        self.moe_stats: Optional[torch.Tensor] = None
        if self._pooled and ecfg.moe_impl == "grouped" and cfg.num_experts:
            self.moe_stats = torch.zeros(
                (cfg.num_layers, 2 * cfg.padded_experts + 2),
                dtype=torch.int64, device=device)
        if self._pooled:
            self.k_pools, self.v_pools = init_pools(
                cfg, self.allocator.num_pages, pg, nslots=ecfg.nslots,
                device=device)
            self._paged_prefill, self._paged_decode = build_paged_fns(
                cfg, moe_impl=ecfg.moe_impl, moe_stats=self.moe_stats)
            self.cache = None
        else:
            self.k_pools = self.v_pools = None
            self.cache = M.init_cache(cfg, ecfg.nslots, ecfg.cache_len,
                                      device=device)
            if self.mesh is not None and _seqsharded(cfg, ecfg):
                spec = spmd.kv_spec(cfg, ecfg.nslots, ecfg.cache_len,
                                    self.mesh)
                spmd.check_split(ecfg.cache_len, "impl='seqsharded': "
                                 "cache_len", self.mesh, "model")
                self.cache = spmd.place_cache(self.cache, spec, self.mesh)
            self._chunk_fn = build_prefill_chunk_fn(
                cfg, impl=ecfg.impl, moe_impl=ecfg.moe_impl)
            self._decode_fn = build_decode_fn(cfg, impl=ecfg.impl,
                                              moe_impl=ecfg.moe_impl,
                                              append=ecfg.decode_append)
        # shared-prefix bookkeeping: chained page keys per rid and the
        # per-grant data-plane skip from a registry hit
        self._page_keys_of: Dict[int, List[int]] = {}
        self._page_tokens_of: Dict[int, List[Tuple[int, ...]]] = {}
        self._prefix_skip: Dict[int, int] = {}
        # the step graphs (one per step shape) and the static block
        # tables every pooled graph reads; _bt_cache is the allocator
        # version _bt_dev holds (see _block_tables_device)
        self.graphs = StepGraphs(eager=self.mesh is not None)
        self._bt_dev = (torch.zeros((ecfg.nslots, self.max_pages),
                                    dtype=torch.int32, device=device)
                        if self._pooled else None)
        self._bt_cache: Optional[int] = None
        # persistent host mirror of the device block tables, refreshed
        # row by row from the allocator's dirty-rid delta
        self._bt_host: Optional[np.ndarray] = None
        # the cohort key of what the decode graph's input buffer holds
        # (pooled plane; None: nothing reusable)
        self._decode_state: Optional[Dict[str, Any]] = None
        self.free_slots: List[int] = list(range(ecfg.nslots - 1, -1, -1))
        self.slot_of: Dict[int, int] = {}
        self.token_ids: Dict[int, List[int]] = {}
        self.outputs: Dict[int, List[int]] = {}
        self.buckets = _bucket_ladder(ecfg.chunk, ecfg.min_bucket)
        # the prefill grids' row counts: the pooled plane packs a round's
        # prefilling rows into the smallest rung.  A slot plane's grid is
        # every slot, merged by slot; so is the pooled grid under a
        # capacity-based MoE dispatch ("sparse", "ep"), whose tokens share
        # the experts' capacity over the whole grid, as in the JAX engine
        packs = self._pooled and (not cfg.num_experts
                                  or ecfg.moe_impl in ("dense", "grouped"))
        self.rungs = _row_rungs(ecfg.nslots) if packs else [ecfg.nslots]
        # host seconds of the step by phase, one key a span
        # (``serving.spans``: attach_s, prefill_s, upload_s, replay_s, ...)
        self.phase_stats: Dict[str, float] = dict.fromkeys(
            spans.KEY.values(), 0.0)
        self.swap_store = KVSwapStore(capacity_bytes=ecfg.swap_bytes)
        # --- failure model: fault plan + step-transaction machinery ----- #
        self.fault_plan: Optional[FaultPlan] = (
            FaultPlan(scheduler.cfg.faults)
            if scheduler.cfg.faults is not None else None)
        if self.fault_plan is not None:
            self.allocator.fault_hook = self._alloc_fault_hook
        self._attempt = 0           # retry index of the current step
        self._alloc_ordinal = 0     # allocation counter within an attempt
        self._last_dt = 0.0         # predicted dt of the last batch
        self._last_wall = 0.0       # measured wall of the last batch
        # the greedy token each slot took in this step (-1: none), which
        # the ranks of a mesh check equal (``spmd.agree``)
        self._emitted = np.full(ecfg.nslots, -1, np.int64)
        # abort history, outside the step txn: rolling a step back must
        # not erase the record of the rollback itself
        self.recovery_stats: Dict[str, float] = {
            SK.ROLLBACKS: 0, SK.ALLOC_FAULTS: 0, SK.INTEGRITY_FAILURES: 0,
            SK.DEGRADED_RECOMPUTES: 0, SK.STRAGGLER_REQUEUES: 0,
            SK.WALL_ABORTED_S: 0.0}
        self._straggler: Optional[StragglerMonitor] = (
            StragglerMonitor(deadline_factor=ecfg.straggler_factor)
            if ecfg.straggler_factor else None)
        # the open attempt's deferred device writes, applied in order at
        # the commit point ((kind, pages, slots, apply); None: no attempt
        # is open, and a write applies at once)
        self._intents: Optional[List[Tuple[str, Tuple[int, ...],
                                           Tuple[int, ...],
                                           Callable[[], None]]]] = None
        self._committed = False     # the open attempt passed its commit
        # the host link: a copy stream on a card (serving.host_copy)
        self._link = HostLink(self.device)
        # in-flight snapshots, finalized at the drain boundaries: the
        # slot plane's (rid -> (entry, enqueue step, transfer)), the
        # prefix tier's (chain key -> (enqueue step, transfer)) and the
        # pooled plane's page runs ((rid, run start) -> (entry, enqueue
        # step, transfer)); an entry's payload stays the gathered device
        # buffers until its drain
        self._pending_swaps: \
            "OrderedDict[int, Tuple[SwapEntry, int, Transfer]]" = \
            OrderedDict()
        self._pending_demotes: "OrderedDict[int, Tuple[int, Transfer]]" = \
            OrderedDict()
        self._pending_runs: \
            "OrderedDict[Tuple[int, int], Tuple[Any, int, Transfer]]" = \
            OrderedDict()
        self._step_no = 0
        # the JAX engine's whole key set; wall_* keys are measured host
        # time
        self.swap_stats: Dict[str, float] = {
            SK.SWAP_OUTS: 0, SK.SWAP_INS: 0, SK.KV_OUT: 0, SK.KV_IN: 0,
            SK.SWAP_FALLBACKS: 0, SK.DRAINS_ON_SWAPIN: 0,
            SK.WALL_OUT_S: 0.0, SK.WALL_IN_S: 0.0,
            SK.PROMOTIONS: 0, SK.DEMOTIONS: 0, SK.DEMOTE_DROPS: 0,
            SK.KV_PROMOTED: 0, SK.KV_DEMOTED: 0,
            SK.WALL_PROMOTE_S: 0.0, SK.WALL_DEMOTE_S: 0.0,
            # fault-injection counters: inside the step txn, so an
            # aborted attempt's draws are not counted twice by its retry
            SK.PERMANENT_STORE_FAILURES: 0, SK.TRANSIENT_RETRIES: 0,
            SK.BACKOFF_S: 0.0, SK.PREFIX_INTEGRITY: 0,
            # radix-trie attach outcomes: attaches that reused at least
            # one page, and the tokens reused by attaches that matched
            # only PART of the queried chain
            SK.TRIE_HITS: 0, SK.PARTIAL_HIT_TOKENS: 0}
        # virtual time owed by prefix-tier traffic (demotions fire inside
        # allocator reclaims, promotions inside the prefix attach), folded
        # into the current batch before its dt is priced
        self._tier_swap_s = 0.0
        # swap-out charges of rounds that admitted no items, owed to the
        # next executed batch (mirrors the simulator)
        self._carry_swap_s = 0.0
        self._carry_out = 0
        # kernel-path step counts: prefill rounds and decode steps run
        # (a round -- on the legacy plane, one exact-shape chunk call --
        # runs every layer's prefill kernel once: paged prefill, or WKV6
        # on RWKV6's slots; a decode step on the pooled plane, or with
        # impl="paged" on the dense slot plane, every layer's paged
        # decode kernel)
        self.prefill_rounds = 0
        self.decode_steps = 0
        # the prefill rounds' real tokens (their chunks' lengths) and the
        # grid they compute (rows x bucket a round; on the legacy plane
        # a chunk's own length): what padding costs; and the rounds run
        # by the grid's rows (a rung on the pooled plane)
        self.prefill_tokens = 0
        self.prefill_grid_tokens = 0
        self.prefill_rounds_by_rows: Dict[int, int] = {}
        self.now = 0.0
        self.wall = 0.0
        self.batch_logs: List[BatchLog] = []

    # ------------------------------------------------------------------ #
    def warmup(self) -> "Engine":
        """Capture every step graph the run loop can hit -- one prefill
        round per (row rung, ladder bucket) and the decode step; on the
        legacy plane, whose prefill runs eagerly, the decode step only --
        as the JAX engine's ``warmup`` compiles every signature.  The
        prefill grids go from the largest to the smallest, so the largest
        sizes the shared pool and the others reuse its blocks, and
        Python's collector runs once for all the captures.  Each graph is
        readied over inert inputs (zero lengths, no active row;
        ``StepGraph.prepare``): on a card its eager warm-up -- the step,
        or a pooled prefill's first layer alone -- then its capture, and
        no step; on the CPU one eager call.  Outputs are discarded, the
        allocator's pages and the slots' state stay bit-identical
        (inactive decode rows write only the sentinel page; the slot
        plane merges no row), and the step counters do not move.  Over a
        mesh it captures nothing: the steps run eagerly.
        """
        if self.mesh is not None:
            return self
        shapes = sorted(((r, b) for r in self.rungs for b in self.buckets),
                        key=lambda s: (s[0] * s[1], s[0]), reverse=True)
        prefill = [] if self._legacy else [self._prefill_graph(b, r)
                                           for r, b in shapes]
        with collector_held():
            for g in prefill + [self._decode_graph()]:
                g.inputs[0].zero_()
                g.prepare()
        self._decode_state = None     # its buffer holds no cohort now
        return self

    @property
    def num_compiles(self) -> int:
        """Always 0: nothing is traced or compiled per signature (the
        CUDA kernels are built once per source, outside any step; the
        steps' CUDA graphs are counted by ``num_graphs``)."""
        return 0

    @property
    def num_graphs(self) -> int:
        """Step graphs built: ``len(rungs) * len(buckets) + 1`` once every
        shape has run (``warmup``), on the CPU and on a card alike (a slot
        plane has one rung, ``nslots``); 1 (the decode step) on the legacy
        plane, whose prefill builds none; 0 over a mesh, where every step
        runs eagerly."""
        return len(self.graphs)

    # --- step graphs (serving.step_graphs) ------------------------------ #
    def _graph_state(self) -> Tuple[torch.Tensor, ...]:
        """What every step graph reads or writes outside its own input:
        the pools and the block tables, or the cache leaves."""
        if self._pooled:
            return (self.k_pools, self.v_pools, self._bt_dev)
        return tuple(self.cache.values())

    def _prefill_graph(self, bucket: int, rows: int) -> StepGraph:
        """The prefill round of one row rung and ladder bucket.  Its
        static input is the round's grid: on the pooled plane (rows,
        bucket + 3) int32 [toks | lens | starts | slot], each row reading
        its slot's block table (``_bt_dev.index_select``), rows that no
        prompt fills inert (length 0); on the slot plane
        (nslots, bucket + 1) [toks | lens], row b being slot b (starts are
        the cache index there; ``rows`` is ``nslots``)."""
        def build():
            if self._pooled:
                grid = torch.zeros((rows, bucket + 3), dtype=torch.int32,
                                   device=self.device)

                def step(g, params, k_pools, v_pools):
                    return self._paged_prefill(
                        params, k_pools, v_pools, g[:, :-3], g[:, -2],
                        g[:, -3], self._bt_dev.index_select(0, g[:, -1]))

                def fn(g):
                    return step(g, self.params, self.k_pools, self.v_pools)

                def warm(g):
                    # the first layer alone runs every kernel at every
                    # shape of the step (the layers are stacked alike), at
                    # 1/L of an eager step's host time, and its K/V writes
                    # are ones the step repeats
                    return step(g, _first_layer(self.params),
                                self.k_pools[:1], self.v_pools[:1])
                return fn, (grid,), self._graph_state, warm
            else:
                grid = torch.zeros((rows, bucket + 1), dtype=torch.int32,
                                   device=self.device)

                def fn(g):
                    return self._prefill_many(g[:, :-1], g[:, -1])
            return fn, (grid,), self._graph_state
        return self.graphs.get(f"prefill/{rows}x{bucket}", build)

    def _decode_graph(self) -> StepGraph:
        """The decode step over all slots.  Pooled plane: its static input
        is the cohort buffer (3, nslots) int32 [toks, ctx, active], which
        the graph itself advances for the next step
        (``paged_plane.decode_and_advance``); slot plane: (2, nslots)
        [toks, active], uploaded every step."""
        def build():
            rows = 3 if self._pooled else 2
            buf = torch.zeros((rows, self.ecfg.nslots), dtype=torch.int32,
                              device=self.device)
            if self._pooled:
                def fn(c):
                    return decode_and_advance(self._paged_decode, self.params,
                                              self.k_pools, self.v_pools, c,
                                              self._bt_dev)
            else:
                def fn(p):
                    return self._decode_many(p[0], p[1].bool())
            return fn, (buf,), self._graph_state
        return self.graphs.get("decode", build)

    def _upload(self, dst: torch.Tensor, host: np.ndarray) -> None:
        """ONE host-to-device copy into a step graph's static input."""
        with span(self.phase_stats, spans.UPLOAD):
            dst.copy_(torch.from_numpy(host))

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"chunk step {n} exceeds ladder {self.buckets}")

    def _rows_for(self, n: int) -> int:
        """The smallest row rung that holds ``n`` prefilling rows."""
        return next(r for r in self.rungs if n <= r)

    # ------------------------------------------------------------------ #
    def submit(self, r: Request) -> None:
        if r.prompt is None:
            raise ValueError("engine requests need real token ids")
        if len(r.prompt) != r.input_len:
            raise ValueError(
                f"request {r.rid}: prompt length {len(r.prompt)} != "
                f"input_len {r.input_len}")
        # window/ssm archs hold bounded state; dense caches must fit
        if not (self.cfg.window or self.cfg.family == "ssm"
                or r.peak_kv <= self.ecfg.cache_len):
            raise ValueError(
                f"request {r.rid} peak KV {r.peak_kv} > cache_len")
        self.token_ids[r.rid] = list(r.prompt)
        self.outputs[r.rid] = []
        self.sched.add_request(r)

    # ------------------------------------------------------------------ #
    def _claim_slot(self, rid: int, reset: bool = True) -> int:
        slot = self.free_slots.pop()
        self.slot_of[rid] = slot
        if reset:
            # a fresh (or refilling) request starts from a zero state: the
            # slot plane owns its cache, so the slot is zeroed in place
            self._write("slot_reset", lambda: self._zero_slot(slot),
                        slots=(slot,))
        return slot

    def _zero_slot(self, slot: int) -> None:
        spmd.zero_slot(self.cache, slot)

    def _release(self, rid: int) -> None:
        slot = self.slot_of.pop(rid, None)
        if slot is not None:
            self.free_slots.append(slot)
            if self._bt_host is not None:
                # the freed rid won't be in slot_of at the next delta
                # rebuild, so its row must be cleared here
                self._bt_host[slot, :] = 0
        self.allocator.free(rid)  # repro: allow-unpriced-mutation(releasing pages moves no bytes; the preemption decision that led here was already charged - refill compute - by the scheduler)

    # --- the commit point: deferred device writes ----------------------- #
    def _write(self, kind: str, apply: Callable[[], None],
               pages: Sequence[int] = (), slots: Sequence[int] = ()) -> None:
        """One device write of an attempt's pre-commit phase (``kind``:
        ``slot_reset``, ``slot_swap_in``, ``run_restore``,
        ``tail_restore``, ``promotion`` or ``cow_copy``) into ``pages`` of
        the pools or ``slots`` of the cache.  Inside an open attempt it
        becomes an intent, applied at
        the commit point (``_commit``) and dropped by a rollback; outside
        one (``warmup``, a direct call) it runs at once.  Its inputs must
        already be fresh device buffers (or stay unwritten until the
        commit): a staged host copy, never a view of the pools."""
        if self._intents is None:
            invariant(not self._committed,
                      f"{kind}: device write after the commit point")
            apply()
            return
        # repro: allow-txn-coverage(the attempt's deferred-write log is opened empty at every attempt start and dropped unapplied by a rollback - that drop is what rolls the pools and slots back)
        self._intents.append((kind, tuple(pages), tuple(slots), apply))

    def _check_unwritten(self, pages: Sequence[int] = (),
                         slots: Sequence[int] = ()) -> None:
        """A gather before the commit reads the pools or the cache as they
        stand: no pending intent of the same attempt may target what it
        reads (the victims' pages and slots, a reclaimed registry page)."""
        if not self._intents:
            return
        pages, slots = set(pages), set(slots)
        hit = [(kind, p, s) for kind, p, s, _ in self._intents
               if pages.intersection(p) or slots.intersection(s)]
        invariant(not hit, ("gather of a page or slot with a pending "
                            "write", sorted(pages), sorted(slots), hit))

    def _commit(self) -> None:
        """The commit point of an attempt: apply its intents in order.
        No fault point follows (``_alloc_fault_hook`` and ``step`` check
        it), so nothing written from here on is ever rolled back."""
        intents, self._intents = self._intents, None
        for *_, apply in intents:
            apply()
        self._committed = True  # repro: allow-txn-coverage(commit flag of the open attempt: set only after the last fault point, cleared when the attempt ends)

    def _drop_intents(self) -> None:
        """The device half of a rollback: the aborted attempt's intents
        go unapplied, so the pools and slots keep their batch-start bytes.
        Their staging buffers are freed in stream order (they were
        allocated and filled on the compute stream), and the pinned
        sources of their copies stay held by the link until the copies
        have passed."""
        invariant(not self._committed, "rollback after the commit point")
        self._intents = None

    # --- failure model: fault hooks, guarded puts, integrity ----------- #
    def _alloc_fault_hook(self, need: int) -> None:
        """``PagedAllocator.fault_hook``: a transient device fault on
        this (step, attempt, ordinal) aborts the attempt.  Keyed by
        attempt so the rolled-back retry draws fresh (no livelock)."""
        invariant(not self._committed,
                  "allocation (a fault point) after the commit point")
        self._alloc_ordinal += 1
        if self.fault_plan.alloc_fault(self._step_no, self._attempt,
                                       self._alloc_ordinal):
            raise FaultError(
                f"injected allocation fault: step {self._step_no} "
                f"attempt {self._attempt} ordinal {self._alloc_ordinal}")

    def _retry_sleep(self, seconds: float) -> None:
        """Injectable backoff clock for ``run_with_retries``: records
        the schedule in virtual time instead of stalling the step."""
        self.swap_stats[SK.BACKOFF_S] += seconds

    _PERM_KIND = {"store_put": "perm_put", "store_run": "perm_run"}

    def _guarded_put(self, kind: str, key: Tuple, do_put):
        """Run a swap-store write under the fault plan.  A permanent
        draw raises ``PermanentStoreError`` (a ``SwapStoreFullError``, so
        the caller's full-store fallback handles it); a transient draw
        fails the write 1-3 times, each retried under
        ``run_with_retries``'s exponential backoff."""
        plan = self.fault_plan
        if plan is None:
            return do_put()
        # seeded, content-keyed draws: every rank of a mesh draws the same
        if plan.decide(self._PERM_KIND[kind], *key):
            self.swap_stats[SK.PERMANENT_STORE_FAILURES] += 1
            raise PermanentStoreError(
                f"injected permanent store failure {kind}{key}")
        remaining = [plan.transient_failures(kind, *key)]

        def attempt():
            if remaining[0] > 0:
                remaining[0] -= 1
                self.swap_stats[SK.TRANSIENT_RETRIES] += 1
                raise TransientStoreError(
                    f"injected transient store failure {kind}{key}")
            return do_put()

        return run_with_retries(attempt, retries=3,
                                retry_on=(TransientStoreError,),
                                sleep=self._retry_sleep)

    def _corrupt_draw(self, kind: str, key: Tuple) -> bool:
        return (self.fault_plan is not None
                and self.fault_plan.decide(kind, *key))

    def _finalize_entry(self, entry) -> None:
        """Seal an entry's host bytes once; apply a pending corruption
        marker exactly once.  The seal-once guard doubles as the
        flip-once guard: after a rollback the engine may re-drain an
        entry that was already finalized (entries are shared by
        reference across snapshots), and re-sealing would bless the
        corruption while re-flipping would undo it."""
        if entry.crc is not None:
            return
        seal_entry(entry)
        if entry.corrupt and entry.crc is not None:
            flip_bit(entry.cache if isinstance(entry, SwapEntry)
                     else entry.kv)

    def _land(self, entry, xfer: Transfer) -> None:
        """Finalize one drained transfer: the host bytes replace the
        entry's gathered device leaves, then ``_finalize_entry``.  A
        rollback restores the ``_pending_*`` maps but not the entries, so
        an entry an aborted attempt already landed can be drained again:
        it is left as it is, since finishing its transfer again would hand
        back the pinned bytes from before a corruption flip."""
        if entry.crc is None:
            host = self._link.finish(xfer)
            if isinstance(entry, SwapEntry):
                entry.cache = host
            else:
                entry.kv = host
        self._finalize_entry(entry)

    def _drop_snapshot_repair(self, r: Request):
        """Post-rollback repair for a corrupt slot snapshot: drop the
        entry and degrade ``r`` to recompute (the suspend never stuck,
        exactly like the store-full fallback)."""
        def repair() -> None:
            self.swap_store.discard(r.rid)
            self._pending_swaps.pop(r.rid, None)
            r.drop_suspended()
            self.sched.num_swaps -= 1
        return repair

    def _drop_runs_repair(self, r: Request, claim: bool):
        """Post-rollback repair for a corrupt page run: drop every stored
        run of ``r`` (a tiling with a rotten stripe is unrestorable as a
        whole) and unwind the matching swap counters, degrading ``r`` to
        recompute."""
        def repair() -> None:
            self._purge_pending_runs(r.rid)
            if claim:                      # fully suspended victim
                n = self.swap_store.discard_runs(r.rid)
                for _ in range(n - 1):     # tail runs beyond the base
                    r.swaps -= 1
                    self.sched.num_swaps -= 1
                r.drop_suspended()
                self.sched.num_swaps -= 1
            else:                          # partially shed victim
                for run in self.swap_store.pop_runs(r.rid):
                    r.drop_tail_run(run.num_tokens)
                    self.sched.num_swaps -= 1
        return repair

    # --- §5.4 swap data plane (slot plane) ------------------------------ #
    def _swap_out(self, victim: Request) -> bool:
        """Snapshot the victim's slot (every cache leaf) to the host store,
        then free it.  Returns False when the store is full: the snapshot
        is dropped and the victim falls back to discard-and-recompute.

        With ``async_swap`` the snapshot is a fresh device gather whose
        host copy starts here and is finalized later (``_drain_swaps``);
        capacity is charged at once from tensor metadata, so the
        full-store fallback stays synchronous and deterministic."""
        t0 = time.perf_counter()
        slot = self.slot_of[victim.rid]
        self._check_unwritten(slots=(slot,))
        # whole rows on every rank: the store's bytes are the one-rank
        # engine's, so are its capacity decisions
        snap = gather_slot(self.cache, self._link.ids([slot]))
        # content key: identical across aborted-attempt retries, so the
        # fault draws are idempotent (the JAX engine's key)
        fkey = (victim.rid, victim.suspended_m, victim.swaps)
        try:
            if self.ecfg.async_swap:
                nbytes = sum(nbytes_of(t) for t in snap.values())
                entry = self._guarded_put(
                    "store_put", fkey,
                    lambda: self.swap_store.put(
                        victim.rid, snap, self.token_ids[victim.rid],
                        victim.suspended_m, nbytes=nbytes))
                entry.corrupt = self._corrupt_draw("corrupt_put", fkey)
                self._pending_swaps[victim.rid] = (
                    entry, self._step_no, self._link.start(snap))
            else:
                host = self._link.fetch(snap)  # repro: allow-host-sync(async_swap=False is the synchronous swap path by choice - the JAX engine's device_get fallback)
                entry = self._guarded_put(
                    "store_put", fkey,
                    lambda: self.swap_store.put(
                        victim.rid, host, self.token_ids[victim.rid],
                        victim.suspended_m))
                if self.ecfg.check_invariants:
                    invariant(int(host["index"][0]) == victim.suspended_m,
                              (victim.rid, host["index"], victim.suspended_m))
                entry.corrupt = self._corrupt_draw("corrupt_put", fkey)
                self._finalize_entry(entry)
        except SwapStoreFullError:
            victim.drop_suspended()
            self.sched.num_swaps -= 1   # the suspend did not stick
            self.swap_stats[SK.SWAP_FALLBACKS] += 1
            self._release(victim.rid)
            return False
        self.swap_stats[SK.SWAP_OUTS] += 1
        self.swap_stats[SK.KV_OUT] += victim.suspended_m
        self.swap_stats[SK.WALL_OUT_S] += time.perf_counter() - t0
        self._release(victim.rid)
        # double buffering: finalize the oldest transfer(s) outside the
        # timed enqueue window above (the drain bills its own wait)
        while len(self._pending_swaps) > 2:
            self._drain_swaps(rid=next(iter(self._pending_swaps)))
        return True

    def _drain_swaps(self, rid: Optional[int] = None,
                     before_step: Optional[int] = None) -> None:
        """Finalize in-flight swap-out transfers: wait for the copy and
        replace the entry's device leaves with host arrays, then seal
        them.  ``rid`` drains one slot entry (same-window re-admission,
        double-buffer pressure); ``before_step`` drains what was enqueued
        before that step (the end-of-step boundary); neither drains
        everything (end of run).  In-flight demotions and page runs share
        the ``before_step`` and drain-all boundaries."""
        # drain boundaries are step numbers and rids, never a clock: every
        # rank of a mesh drains the same transfers
        if rid is not None:
            rids = [rid] if rid in self._pending_swaps else []
        elif before_step is not None:
            rids = [r for r, (_, s, _) in self._pending_swaps.items()
                    if s < before_step]
        else:
            rids = list(self._pending_swaps)
        for r in rids:
            entry, _, xfer = self._pending_swaps.pop(r)
            t0 = time.perf_counter()
            self._land(entry, xfer)       # CRC seal (+ fault-plan flip)
            if self.ecfg.check_invariants:
                invariant(int(entry.cache["index"][0]) == entry.num_kv,
                          (r, entry.cache["index"], entry.num_kv))
            self.swap_stats[SK.WALL_OUT_S] += time.perf_counter() - t0
        if rid is None:
            if before_step is not None:
                keys = [k for k, (s, _) in self._pending_demotes.items()
                        if s < before_step]
            else:
                keys = list(self._pending_demotes)
            for k in keys:
                self._drain_demotes(key=k)
            self._drain_runs(before_step=before_step)
            # restore sources whose host-to-device copies have passed
            self._link.release(wait=before_step is None)

    def _drain_demotes(self, key: int) -> None:
        """Finalize one in-flight prefix-page demotion.  A key whose entry
        was promoted (or discarded) before the drain is forgotten: its
        bytes never round-tripped."""
        _, xfer = self._pending_demotes.pop(key)
        entry = self.swap_store.peek_prefix(key)
        if entry is None:
            return
        t0 = time.perf_counter()
        self._land(entry, xfer)   # prefix rot is a flag, never flipped
        self.swap_stats[SK.WALL_DEMOTE_S] += time.perf_counter() - t0

    def _swap_in(self, r: Request) -> None:
        """Restore r's slot snapshot into a free slot; no refill.  The
        snapshot's host bytes are staged on the card at once; the slot is
        written at the commit point."""
        if r.rid in self._pending_swaps:
            # re-admitted within the drain window: finalize on demand
            self.swap_stats[SK.DRAINS_ON_SWAPIN] += 1
            self._drain_swaps(rid=r.rid)
        if not verify_entry(self.swap_store.peek(r.rid)):
            # rung 3: abort the step; after the rollback the repair drops
            # the entry and degrades r to recompute
            raise IntegrityError(
                f"rid {r.rid}: corrupt swap snapshot",
                repairs=[self._drop_snapshot_repair(r)])
        t0 = time.perf_counter()
        entry = self.swap_store.pop(r.rid)
        slot = self._claim_slot(r.rid, reset=False)  # fully overwritten
        ids = self._link.ids([slot])
        staged = {k: self._link.to_device(v, self.cache[k])
                  for k, v in entry.cache.items()}
        self._write("slot_swap_in",
                    lambda: restore_slot(self.cache, ids, staged),
                    slots=(slot,))
        self.allocator.allocate(r.rid, entry.num_kv)
        restored = r.resume()
        if self.ecfg.check_invariants:
            invariant(restored == entry.num_kv, (r.rid, restored, entry.num_kv))
            invariant(self.token_ids[r.rid] == entry.tokens, r.rid)
        self.swap_stats[SK.SWAP_INS] += 1
        self.swap_stats[SK.KV_IN] += entry.num_kv
        self.swap_stats[SK.WALL_IN_S] += time.perf_counter() - t0

    # --- pooled (paged) swap data plane --------------------------------- #
    def _check_run_capacity(self, npages: int) -> None:
        """Raise ``SwapStoreFullError`` from shape metadata BEFORE the
        page gather: a doomed snapshot must not pay the transfer."""
        cap = self.swap_store.capacity_bytes
        if cap is None:
            return
        # shape arithmetic on pools that are whole on every rank of a mesh
        nbytes = 2 * self.cfg.num_layers * npages * self.ecfg.page_size \
            * self.cfg.num_kv_heads * self.cfg.head_dim_ \
            * self.k_pools.element_size()
        if self.swap_store.nbytes + nbytes > cap:
            raise SwapStoreFullError(
                f"page run of {npages} pages ({nbytes}B) over capacity "
                f"({self.swap_store.nbytes}/{cap}B held)")

    def _snapshot_pages(self, page_ids) -> Dict[str, np.ndarray]:
        """The synchronous page snapshot ``async_swap=False`` selects."""
        self._check_unwritten(pages=page_ids)
        return self._link.fetch(gather_pages(  # repro: allow-host-sync(async_swap=False selects this synchronous snapshot - the JAX engine's device_get fallback)
            self.k_pools, self.v_pools, self._link.ids(page_ids)))

    def _gather_pages_device(self, page_ids
                             ) -> Tuple[Dict[str, torch.Tensor], Transfer]:
        """Async page snapshot: gather the pages into fresh device buffers
        (later pool writes, and freeing the source pages, cannot reach
        them) and start the host copy at once; the host bytes land at a
        drain boundary (``_drain_runs``).  This is what lets
        ``_shed_tail`` free the gathered pages in the same step."""
        self._check_unwritten(pages=page_ids)
        kv = gather_pages(self.k_pools, self.v_pools,
                          self._link.ids(page_ids))
        return kv, self._link.start(kv)

    def _drain_runs(self, rid: Optional[int] = None,
                    before_step: Optional[int] = None) -> None:
        """Finalize in-flight page-run snapshots (the pooled plane's
        ``_drain_swaps``)."""
        if rid is not None:
            keys = [k for k in self._pending_runs if k[0] == rid]
        elif before_step is not None:
            keys = [k for k, (_, s, _) in self._pending_runs.items()
                    if s < before_step]
        else:
            keys = list(self._pending_runs)
        for k in keys:
            entry, _, xfer = self._pending_runs.pop(k)
            t0 = time.perf_counter()
            self._land(entry, xfer)       # CRC seal (+ fault-plan flip)
            self.swap_stats[SK.WALL_OUT_S] += time.perf_counter() - t0

    def _purge_pending_runs(self, rid: int) -> None:
        """Forget in-flight snapshots of runs the store no longer holds
        (full-store unwind, recompute discard): their entries were already
        popped.  Dropping a transfer is safe: its source is marked as used
        by the copy stream, and the host allocator keeps its pinned
        buffer until the copy has passed."""
        for k in [k for k in self._pending_runs if k[0] == rid]:
            del self._pending_runs[k]

    def _restore_pages(self, page_ids, kv, kind: str = "run_restore"
                       ) -> None:
        """Write a snapshot's pages into ``page_ids`` of the pools: the
        host bytes are staged on the card now, the pools written at the
        commit point."""
        ids = self._link.ids(page_ids)
        staged = {"k": self._link.to_device(kv["k"], self.k_pools),
                  "v": self._link.to_device(kv["v"], self.v_pools)}
        self._write(kind, lambda: restore_pages(self.k_pools, self.v_pools,
                                                ids, staged),
                    pages=page_ids)

    def _swap_out_paged(self, victim: Request) -> bool:
        """Full suspend in the pooled plane: one ``PageRunEntry`` covering
        every device page (tail runs shed earlier are already in the
        store; together they tile [0, suspended_m)).  Returns False when
        the store is full: the victim (and any stored tail runs) falls
        back to discard-and-recompute."""
        t0 = time.perf_counter()
        tbl = self.allocator.table(victim.rid)
        device_tokens = tbl.num_tokens
        # the slot plane's key shape, so a fault mirror is plane-agnostic
        fkey = (victim.rid, victim.suspended_m, victim.swaps)
        try:
            self._check_run_capacity(len(tbl.pages))  # before the copy
            if self.ecfg.async_swap:
                kv, xfer = self._gather_pages_device(tbl.pages)
                entry = self._guarded_put(
                    "store_put", fkey,
                    lambda: self.swap_store.put_run(
                        victim.rid, start=0, num_tokens=device_tokens,
                        kv=kv,
                        nbytes=nbytes_of(kv["k"]) + nbytes_of(kv["v"])))
                entry.corrupt = self._corrupt_draw("corrupt_put", fkey)
                self._pending_runs[(victim.rid, 0)] = (entry, self._step_no,
                                                       xfer)
            else:
                host = self._snapshot_pages(tbl.pages)
                entry = self._guarded_put(
                    "store_put", fkey,
                    lambda: self.swap_store.put_run(
                        victim.rid, start=0, num_tokens=device_tokens,
                        kv=host))
                entry.corrupt = self._corrupt_draw("corrupt_put", fkey)
                self._finalize_entry(entry)
        except SwapStoreFullError:
            # stored tail runs are unrestorable without the device
            # portion: unwind their swap counts along with this one
            if self.swap_store.has_runs(victim.rid):
                for _ in self.swap_store.pop_runs(victim.rid):
                    victim.swaps -= 1
                    self.sched.num_swaps -= 1
                    self.swap_stats[SK.SWAP_FALLBACKS] += 1
            self._purge_pending_runs(victim.rid)
            victim.drop_suspended()
            self.sched.num_swaps -= 1   # the suspend did not stick
            self.swap_stats[SK.SWAP_FALLBACKS] += 1
            self._release(victim.rid)
            return False
        self.swap_stats[SK.SWAP_OUTS] += 1
        self.swap_stats[SK.KV_OUT] += device_tokens
        self.swap_stats[SK.WALL_OUT_S] += time.perf_counter() - t0
        self._release(victim.rid)
        while len(self._pending_runs) > 2:
            self._drain_runs(rid=next(iter(self._pending_runs))[0])
        return True

    def _shed_tail(self, r: Request, npages: int, n_tokens: int,
                   mode: str) -> bool:
        """Page-level partial preemption: snapshot (swap mode) and free
        only the victim's last ``npages`` pages.  Returns True iff the run
        was swapped (the caller charges its host-link time); a full store
        falls back to recompute for this run."""
        tbl = self.allocator.table(r.rid)
        start = tbl.num_tokens - n_tokens
        swapped = False
        if mode == "swap":
            t0 = time.perf_counter()
            # r.m is already the run's start (the scheduler's
            # partial_preempt), so the key is stable across retries
            fkey = (r.rid, r.m, n_tokens, r.partial_preemptions)
            try:
                self._check_run_capacity(npages)   # before the copy
                if self.ecfg.async_swap:
                    # the gather's fresh buffers are what make the
                    # free_tail below safe in the same step
                    kv, xfer = self._gather_pages_device(tbl.pages[-npages:])
                    entry = self._guarded_put(
                        "store_run", fkey,
                        lambda: self.swap_store.put_run(
                            r.rid, start=start, num_tokens=n_tokens, kv=kv,
                            nbytes=nbytes_of(kv["k"]) + nbytes_of(kv["v"])))
                    entry.corrupt = self._corrupt_draw("corrupt_run", fkey)
                    self._pending_runs[(r.rid, start)] = (
                        entry, self._step_no, xfer)
                else:
                    host = self._snapshot_pages(tbl.pages[-npages:])
                    entry = self._guarded_put(
                        "store_run", fkey,
                        lambda: self.swap_store.put_run(
                            r.rid, start=start, num_tokens=n_tokens,
                            kv=host))
                    entry.corrupt = self._corrupt_draw("corrupt_run", fkey)
                    self._finalize_entry(entry)
                swapped = True
                self.swap_stats[SK.SWAP_OUTS] += 1
                self.swap_stats[SK.KV_OUT] += n_tokens
                self.swap_stats[SK.WALL_OUT_S] += time.perf_counter() - t0
            except SwapStoreFullError:
                r.drop_tail_run(n_tokens)
                self.sched.num_swaps -= 1
                self.swap_stats[SK.SWAP_FALLBACKS] += 1
                # the failed run sits BELOW every run already stored for
                # this rid (the tail is shed top-down): the stored tiling
                # now has a gap, so those runs fold back to recompute too
                if self.swap_store.has_runs(r.rid):
                    for run in self.swap_store.pop_runs(r.rid):
                        r.drop_tail_run(run.num_tokens)
                        self.sched.num_swaps -= 1
                        self.swap_stats[SK.SWAP_FALLBACKS] += 1
                self._purge_pending_runs(r.rid)
        removed = self.allocator.free_tail(r.rid, npages)
        if self.ecfg.check_invariants:
            invariant(removed == n_tokens, (r.rid, removed, n_tokens))
        if swapped:
            while len(self._pending_runs) > 2:
                self._drain_runs(rid=next(iter(self._pending_runs))[0])
        return swapped

    def _swap_in_paged(self, r: Request) -> None:
        """Restore a fully suspended pooled request: fresh pages, and
        every stored run written back in ascending start order."""
        self._restore_runs(r, claim=True, resume=r.resume)

    def _swap_in_tail(self, r: Request) -> None:
        """Restore a partially shed request's tail runs before its next
        compute step (the kept prefix never left the device)."""
        self._restore_runs(r, claim=False, resume=r.resume_tail)

    def _restore_runs(self, r: Request, *, claim: bool, resume) -> None:
        if any(k[0] == r.rid for k in self._pending_runs):
            # re-admitted within the drain window: finalize on demand,
            # before the verify below (an undrained entry has no seal)
            self.swap_stats[SK.DRAINS_ON_SWAPIN] += 1
            self._drain_runs(rid=r.rid)
        if not all(verify_entry(run)
                   for run in self.swap_store.peek_runs(r.rid)):
            # rung 3: one rotten stripe poisons the whole tiling; after
            # the rollback the repair drops every stored run of r
            raise IntegrityError(
                f"rid {r.rid}: corrupt page run",
                repairs=[self._drop_runs_repair(r, claim)])
        t0 = time.perf_counter()
        runs = self.swap_store.pop_runs(r.rid)
        total = sum(run.num_tokens for run in runs)
        if claim:
            self._claim_slot(r.rid, reset=False)
        self.allocator.allocate(r.rid, total)
        self._write_runs(r.rid, runs,
                         kind="run_restore" if claim else "tail_restore")
        restored = resume()
        if self.ecfg.check_invariants:
            invariant(restored == total, (r.rid, restored, total))
        self.swap_stats[SK.SWAP_INS] += len(runs)   # run-for-run with outs
        self.swap_stats[SK.KV_IN] += total
        self.swap_stats[SK.WALL_IN_S] += time.perf_counter() - t0

    def _write_runs(self, rid: int, runs, kind: str) -> None:
        pg = self.ecfg.page_size
        tbl = self.allocator.table(rid)
        for run in runs:
            invariant(run.start % pg == 0, (rid, run.start))
            p0 = run.start // pg
            npg = -(-run.num_tokens // pg)
            self._restore_pages(tbl.pages[p0:p0 + npg], run.kv, kind)

    # --- shared-prefix reuse -------------------------------------------- #
    def _page_keys(self, r: Request) -> List[int]:
        keys = self._page_keys_of.get(r.rid)
        if keys is None:
            keys = chain_keys(r.prompt, self.ecfg.page_size)
            self._page_keys_of[r.rid] = keys
        return keys

    def _page_tokens(self, r: Request, n: int) -> List[Tuple[int, ...]]:
        """Token ids of the first n full prompt pages (the registry's
        collision-verification payload), memoized per rid."""
        toks = self._page_tokens_of.get(r.rid)
        if toks is None or len(toks) < n:
            pg = self.ecfg.page_size
            toks = [tuple(r.prompt[i * pg:(i + 1) * pg]) for i in range(n)]
            self._page_tokens_of[r.rid] = toks
        return toks[:n]

    def _demote_prefix(self, key: int, page: int, tokens, n_kvs: int
                       ) -> None:
        """Allocator eviction hook: snapshot the evicted registry page to
        the host demotion tier (a refcount-free ``PrefixPageEntry``)
        instead of discarding its KV.  A full store drops the demotion
        (the page recomputes on its next miss).  Charged
        ``swap_time(page_size)`` in virtual time, folded into the current
        batch, and measured on the wall.  With ``async_swap`` the page is
        gathered on the device (the pool page can be reused at once) and
        its host copy finalized at the next drain boundary."""
        if self.swap_store.has_prefix(key):
            return          # an identical snapshot is already host-resident
        if self.fault_plan is not None \
                and self.fault_plan.decide("demote_fail", key):
            # the copy "never lands": drop the demotion with no charge
            # (the page recomputes on its next miss)
            self.swap_stats[SK.DEMOTE_DROPS] += 1
            return
        t0 = time.perf_counter()
        try:
            self._check_run_capacity(1)     # metadata check BEFORE the copy
            if self.ecfg.async_swap:
                kv, xfer = self._gather_pages_device([page])
                self.swap_store.put_prefix(
                    key, tokens, n_kvs, kv,
                    nbytes=nbytes_of(kv["k"]) + nbytes_of(kv["v"]))
                self._pending_demotes[key] = (self._step_no, xfer)
            else:
                seal_entry(self.swap_store.put_prefix(
                    key, tokens, n_kvs, self._snapshot_pages([page])))
        except SwapStoreFullError:
            self.swap_stats[SK.DEMOTE_DROPS] += 1
            return
        pg = self.ecfg.page_size
        self._tier_swap_s += self._swap_time(pg)
        self.swap_stats[SK.DEMOTIONS] += 1
        self.swap_stats[SK.KV_DEMOTED] += pg
        self.swap_stats[SK.WALL_DEMOTE_S] += time.perf_counter() - t0
        # double buffering, as in _swap_out
        while len(self._pending_demotes) > 2:
            self._drain_demotes(key=next(iter(self._pending_demotes)))

    def _verify_prefix(self, entry) -> bool:
        """Promotion gate of ``attach_prefix_run``: CRC-check the
        host-resident page and consult the fault plan (``corrupt_prefix``
        models rot the CRC would catch, flagged and never flipped;
        ``promote_fail`` a failed host read).  A failed entry is dropped
        by the attach, and the page recomputes."""
        plan = self.fault_plan
        ok = verify_entry(entry) and not (
            plan is not None
            and (plan.decide("corrupt_prefix", entry.key)
                 or plan.decide("promote_fail", entry.key)))
        if not ok:
            self.swap_stats[SK.PREFIX_INTEGRITY] += 1
        return ok

    def _promote_restore(self, page: int, kv) -> None:
        t0 = time.perf_counter()
        self._restore_pages([page], kv, kind="promotion")
        self.swap_stats[SK.WALL_PROMOTE_S] += time.perf_counter() - t0

    def _attach_prefix(self, r: Request, c: int) -> int:
        """At a fresh claim, map the LONGEST cached run matching the
        prompt's leading full pages into r's block table and return the
        number of tokens whose prefill compute is SKIPPED.  With demotion
        on, the run extends against the host tier: a host hit promotes
        the page back, charged ``swap_time`` into this batch like a §5.4
        swap-in.  At least one granted token is always computed (the
        emitting batch needs real logits), and only pages wholly inside
        this grant qualify."""
        pg = self.ecfg.page_size
        cap = min(r.input_len - 1, c - 1) // pg
        if pg <= 1 or cap <= 0:
            return 0
        attached, promoted = attach_prefix_run(
            self.allocator, r.rid, self._page_keys(r)[:cap],
            self._page_tokens(r, cap),
            host_tier=self.swap_store if self._demotion else None,
            restore=self._promote_restore,
            verify=self._verify_prefix if self._demotion else None,
            exact=self.sched.cfg.prefix_lookup == "exact")
        if promoted:
            self._tier_swap_s += self._swap_time(promoted)
            self.swap_stats[SK.PROMOTIONS] += promoted // pg
            self.swap_stats[SK.KV_PROMOTED] += promoted
        if attached:
            self.swap_stats[SK.TRIE_HITS] += 1
            if attached < cap * pg:
                self.swap_stats[SK.PARTIAL_HIT_TOKENS] += attached
        return attached

    def _register_prefix(self, r: Request, m_new: int) -> None:
        """Publish the now-complete full PROMPT pages to the registry
        (generated-token pages are never shared)."""
        n = min(m_new, r.input_len) // self.ecfg.page_size
        if n > 0 and self.allocator.has(r.rid):
            # repro: allow-unpriced-mutation(registration moves no bytes - the pages already live on device, owned by rid)
            self.allocator.register_prefix(r.rid, self._page_keys(r)[:n],
                                           self._page_tokens(r, n))

    def _cow_guard(self, rid: int, pos: int) -> None:
        """Copy-on-write: an in-page append at token position ``pos``
        writes into an existing page — remap + copy it first if shared
        or registry-pinned.  The prefill kernel relies on this: it reads
        shared pages and writes only private ones."""
        pg = self.ecfg.page_size
        if pos % pg == 0:
            return                      # boundary: a fresh private page
        moved = self.allocator.ensure_private(rid, pos // pg)  # repro: allow-unpriced-mutation(CoW remap is a device-side page copy with no host traffic; its cost rides the batch_time)
        if moved is not None:
            # applied at the commit point, in order after every earlier
            # intent, so ``old`` is read with what those wrote into it
            old, new = moved
            self._write("cow_copy", lambda: self._copy_page(old, new),
                        pages=(new,))

    def _copy_page(self, old: int, new: int) -> None:
        self.k_pools[:, new] = self.k_pools[:, old]
        self.v_pools[:, new] = self.v_pools[:, old]

    def _block_tables_device(self) -> torch.Tensor:
        """The static (nslots, max_pages) int32 block tables every pooled
        step graph reads (``_bt_dev``), brought up to the allocator's
        mutation version: on a bump only the rows of rids whose page list
        changed (``consume_dirty``) are rewritten in the host mirror,
        which then ships in ONE copy into the buffer.  Called only after
        the commit point, so what the buffer holds (``_bt_cache``) is
        never a rolled-back attempt's."""
        v = self.allocator.version
        if self._bt_cache == v:
            return self._bt_dev
        with span(self.phase_stats, spans.BLOCK_TABLES):
            if self._bt_host is None:
                self._bt_host = np.zeros((self.ecfg.nslots, self.max_pages),
                                         np.int32)
                self.allocator.consume_dirty()
                dirty = set(self.slot_of)          # first build: all rows
            else:
                dirty = self.allocator.consume_dirty()
            for rid in dirty:
                slot = self.slot_of.get(rid)
                if slot is None:
                    continue  # freed rid: _release already zeroed its row
                row = self._bt_host[slot]
                row[:] = 0
                if self.allocator.has(rid):
                    pages = self.allocator.table(rid).pages
                    row[:len(pages)] = pages
            self._bt_dev.copy_(torch.from_numpy(self._bt_host))
            self._bt_cache = v
        return self._bt_dev

    def _swap_time(self, n_kvs: int) -> float:
        return self.cost_model.swap_time(n_kvs) if self.cost_model else 0.0

    # ------------------------------------------------------------------ #
    def _run_prefill_rounds(self, plans, emits, stage) -> Dict[int, int]:
        """Bucketed round loop: each round takes the next sub-chunk of
        every plan with tokens left, padded to the bucket ladder, into the
        prefill graph of the smallest row rung that holds them, and
        replays it.  On a full grid (``nslots`` rows) row b is slot b;
        on a smaller rung the rows are packed first, in plan order, and
        the rest are inert (length 0).  ``stage(dst, at, toks, lens,
        starts, slots)`` uploads the round's rows (one a plan) into the
        graph's static input ``dst`` at rows ``at``.  Only the sampled ids
        are fetched, and only on rounds where some emitting request
        finishes its batch allotment.  ``plans`` rows are [request, slot,
        cursor, remaining]."""
        ps = self.phase_stats
        final_tok: Dict[int, int] = {}
        while True:
            live = [p for p in plans if p[3] > 0]
            if not live:
                break
            with span(ps, spans.ROUND):
                lens = np.array([min(self.ecfg.chunk, p[3]) for p in live],
                                np.int32)
                starts = np.array([p[2] for p in live], np.int32)
                slots = np.array([p[1] for p in live], np.int32)
                bucket = self._bucket_for(int(lens.max()))
                toks = np.zeros((len(live), bucket), np.int32)
                finishing: List[Tuple[Request, int]] = []
                for i, p in enumerate(live):
                    r, _, cursor, _ = p
                    sc = int(lens[i])
                    toks[i, :sc] = self.token_ids[r.rid][cursor:cursor + sc]
                    p[2] += sc
                    p[3] -= sc
                    if p[3] == 0 and emits[r.rid]:
                        finishing.append((r, i))
                rows = self._rows_for(len(live))
                at = slots if rows == self.ecfg.nslots \
                    else np.arange(len(live))
                g = self._prefill_graph(bucket, rows)
                stage(g.inputs[0], at, toks, lens, starts, slots)
                self._count_round(int(lens.sum()), rows, bucket)
                with span(ps, spans.REPLAY):
                    tok_ids = g()
                if finishing:
                    with span(ps, spans.FETCH):
                        host = tok_ids.cpu().numpy()  # repro: allow-host-sync(per-step sampled-token fetch - ids must reach the host to extend prompts and detect EOS; (rows,) int32 only)
                    for r, i in finishing:
                        final_tok[r.rid] = int(host[at[i]])
        return final_tok

    def _count_round(self, tokens: int, rows: int, width: int) -> None:
        """One prefill round run: ``tokens`` real tokens on a grid of
        ``rows`` x ``width`` (``prefill_tokens`` / ``prefill_grid_tokens``
        / ``prefill_rounds_by_rows``).  Called after the commit point
        only, so an aborted attempt never moves the counters."""
        self.prefill_rounds += 1
        self.prefill_tokens += tokens
        self.prefill_grid_tokens += rows * width
        by = self.prefill_rounds_by_rows
        by[rows] = by.get(rows, 0) + 1

    def _merge(self, active: torch.Tensor,
               new_cache: Dict[str, torch.Tensor]) -> None:
        """Take the rows of ``active`` (nslots,) from ``new_cache`` into
        the engine's cache leaves, in place (``merge_rows``)."""
        merge_rows(self.cache, active, new_cache)

    def _prefill_many(self, tokens: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
        """One bucketed chunk round over ALL slots (tokens (nslots,
        bucket), lengths (nslots,), 0 = inert row): greedy ids (nslots,)
        sampled on the device, the state merged into live rows."""
        # a sequence-sharded cache is gathered whole (the chunk attends to
        # every cached position); the merge writes each rank's block
        cache = {k: spmd.full_value(v) for k, v in self.cache.items()}
        logits, new_cache = self._chunk_fn(self.params, tokens, cache,
                                           lengths)
        self._merge(lengths > 0, new_cache)
        return torch.argmax(logits[:, :self.cfg.vocab_size],
                            dim=-1).to(torch.int32)

    def _decode_many(self, tokens: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
        """One decode step over ALL slots; only ``active`` rows keep it."""
        logits, new_cache = self._decode_fn(self.params, tokens, self.cache)
        self._merge(active, new_cache)
        return torch.argmax(logits[:, :self.cfg.vocab_size],
                            dim=-1).to(torch.int32)

    def _run_prefills_legacy(self, prefill_items) -> Dict[int, int]:
        """The legacy plane (JAX's ``_run_prefills_legacy``): for each
        request, an exact-shape chunk loop on its own slot -- a fresh
        gather of the slot, ``prefill_chunk`` with no ``length``, the new
        state written back into the same leaves (``restore_slot``: the
        decode graph is captured against them).  Eager on every device:
        one JAX compile per tail length is what this plane measures.
        Each chunk call counts as a prefill round (it runs every layer's
        prefill kernel once)."""
        self._check_in_cache(prefill_items)
        final_tok: Dict[int, int] = {}
        for r, c in prefill_items:
            slot = self._link.ids([self.slot_of[r.rid]])
            ids = self.token_ids[r.rid]
            start, remaining = r.m, c
            logits = None
            while remaining > 0:
                step_c = min(self.ecfg.chunk, remaining)
                toks = torch.tensor([ids[start:start + step_c]],
                                    dtype=torch.int32, device=self.device)
                logits, new = self._chunk_fn(
                    self.params, toks, gather_slot(self.cache, slot), None)
                restore_slot(self.cache, slot, new)
                self._count_round(step_c, 1, step_c)
                start += step_c
                remaining -= step_c
            if r.m + c == r.target_context:   # this batch emits a token
                final_tok[r.rid] = int(torch.argmax(  # repro: allow-host-sync(legacy plane: one sampled id per emitting request, as the JAX engine's _sample)
                    logits[0, :self.cfg.vocab_size]))
        return final_tok

    def _check_in_cache(self, prefill_items) -> None:
        """Every prompt token a slot plane writes lies inside the dense
        cache: ``submit`` refuses a request whose peak KV exceeds
        ``cache_len``, so the chunk step's wrap (``attention_chunk``;
        JAX clamps such a token to the last slot instead) is never hit.
        A sliding window's ring wraps by design."""
        invariant(self.cfg.family == "ssm" or self.cfg.window or all(
            r.m + c <= self.ecfg.cache_len for r, c in prefill_items),
            [(r.rid, r.m, c) for r, c in prefill_items])

    def _run_prefills_batched(self, prefill_items) -> Dict[int, int]:
        """Slot plane: the shared round loop over the bucket graphs of
        ``_prefill_many`` (starts are implicit in the cache index)."""
        self._check_in_cache(prefill_items)
        plans = [[r, self.slot_of[r.rid], r.m, c] for r, c in prefill_items]
        emits = {r.rid: r.m + c == r.target_context for r, c in prefill_items}

        def stage(dst, at, toks, lens, starts, slots):   # [toks | lens]
            grid = np.zeros(tuple(dst.shape), np.int32)
            grid[at, :-1] = toks
            grid[at, -1] = lens
            self._upload(dst, grid)

        return self._run_prefill_rounds(plans, emits, stage)

    def _run_decodes_batched(self, decode_items) -> np.ndarray:
        """Slot plane: one decode-graph replay over all slots, kept by the
        rows of ``decode_items``."""
        packed = np.zeros((2, self.ecfg.nslots), np.int32)   # toks, active
        for r, _ in decode_items:
            packed[:, self.slot_of[r.rid]] = (self.token_ids[r.rid][-1], 1)
        g = self._decode_graph()
        self._upload(g.inputs[0], packed)
        self.decode_steps += 1
        with span(self.phase_stats, spans.REPLAY):
            tok_ids = g()
        with span(self.phase_stats, spans.FETCH):
            return tok_ids.cpu().numpy()  # repro: allow-host-sync(per-step sampled-token fetch - ids must reach the host to extend prompts and detect EOS; (nslots,) int32 only)

    def _run_prefills_paged(self, prefill_items) -> Dict[int, int]:
        """The round loop over the fused paged prefill.  A grant's
        leading registry-shared tokens (``_prefix_skip``) are satisfied by
        page mapping and never computed (the cursor starts past them)."""
        plans = []
        for r, c in prefill_items:
            skip = self._prefix_skip.pop(r.rid, 0)
            plans.append([r, self.slot_of[r.rid], r.m + skip, c - skip])
        emits = {r.rid: r.m + c == r.target_context for r, c in prefill_items}
        self._block_tables_device()

        def stage(dst, at, toks, lens, starts, slots):
            # one coalesced upload per round: [toks | lens | starts | slot];
            # an inert row reads any slot's table and writes nothing
            grid = np.zeros(tuple(dst.shape), np.int32)
            grid[:, -1] = np.arange(len(grid))
            grid[at, :-3] = toks
            grid[at, -3] = lens
            grid[at, -2] = starts
            grid[at, -1] = slots
            self._upload(dst, grid)

        return self._run_prefill_rounds(plans, emits, stage)

    def _run_decodes_paged(self, decode_items) -> np.ndarray:
        """One decode-graph replay over all slots against the pooled KV.

        Steady-state decode uploads NOTHING: the graph ends by writing
        step N+1's inputs into its own cohort buffer -- step N's argmax
        ids ARE the next tokens, and ctx advances by the active mask --
        so a stable cohort runs entirely device-resident.  The cohort is
        carried in that input buffer, never in a graph output: every
        graph of the engine shares one memory pool, so a prefill replay
        between two decode steps may overwrite any graph's outputs.  The
        cohort key is (rid, slot, m, len(token_ids)) per row: any
        admission, finish, preemption or recompute-refill perturbs it and
        forces one packed re-upload.  Non-cohort rows carry garbage on a
        hit, harmlessly: inactive rows write only the sentinel page and
        their outputs are never read."""
        nslots = self.ecfg.nslots
        key = tuple(sorted(
            (r.rid, self.slot_of[r.rid], r.m, len(self.token_ids[r.rid]))
            for r, _ in decode_items))
        st = self._decode_state
        g = self._decode_graph()
        if st is None or st["key"] != key:
            packed = np.zeros((3, nslots), np.int32)   # toks, ctx, active
            for r, _ in decode_items:
                slot = self.slot_of[r.rid]
                packed[:, slot] = (self.token_ids[r.rid][-1], r.m, 1)
            self._upload(g.inputs[0], packed)
        self._block_tables_device()
        self.decode_steps += 1
        with span(self.phase_stats, spans.REPLAY):
            tok_ids = g()
        nxt = tuple(sorted(
            (r.rid, self.slot_of[r.rid], r.m + 1,
             len(self.token_ids[r.rid]) + 1) for r, _ in decode_items))
        self._decode_state = {"key": nxt}
        with span(self.phase_stats, spans.FETCH):
            return tok_ids.cpu().numpy()  # repro: allow-host-sync(per-step sampled-token fetch - ids must reach the host to extend prompts and detect EOS; (nslots,) int32 only)

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """Run one scheduler batch atomically, as the JAX engine does.
        Returns the number of items executed.

        The batch runs inside a step transaction.  An injected transient
        fault (``FaultError``) or a corrupt host snapshot
        (``IntegrityError``) aborts the attempt: every participant rolls
        back to batch start, the attempt's device writes are dropped
        unapplied (they wait for the commit point, ``_commit``), the
        error's repairs degrade poisoned requests to recompute, and the
        step retries.  A real ``OutOfPagesError`` rolls back too but
        re-raises."""
        if not self.sched.has_work():
            return 0
        with span(self.phase_stats, spans.STEP):
            self._step_no += 1  # repro: allow-txn-coverage(step identity deliberately survives rollback - a retried attempt is the SAME step, and drain/fault keying depends on that)
            for attempt in range(_MAX_STEP_ATTEMPTS):
                # repro: allow-txn-coverage(attempt bookkeeping is reset at every attempt start and keys the per-attempt fault draws - restoring it would replay attempt 0's faults forever)
                self._attempt, self._alloc_ordinal = attempt, 0
                self._emitted.fill(-1)  # repro: allow-txn-coverage(the step's tokens for the ranks' check: reset at every attempt start, written only after the commit point)
                txn = self._begin_txn()
                # repro: allow-txn-coverage(the deferred-write log is opened empty at every attempt start; a rollback drops it unapplied, which is what rolls the pools and slots back)
                self._intents, self._committed = [], False
                t0 = time.perf_counter()
                try:
                    executed = self._step_attempt()
                except (FaultError, IntegrityError) as e:
                    self._drop_intents()
                    txn.rollback()
                    aborted_s = time.perf_counter() - t0
                    self.wall += aborted_s  # repro: allow-txn-coverage(measured wall of the aborted attempt is real elapsed time - rolling it back would hide the recovery cost)
                    # repro: allow-txn-coverage(recovery accounting counts rollbacks so it must survive them - written only AFTER txn.rollback, never inside a txn)
                    self.recovery_stats[SK.ROLLBACKS] += 1
                    self.recovery_stats[SK.WALL_ABORTED_S] += aborted_s
                    if isinstance(e, IntegrityError):
                        self.recovery_stats[SK.INTEGRITY_FAILURES] += 1
                        self.recovery_stats[SK.DEGRADED_RECOMPUTES] += 1
                        for repair in e.repairs:   # on rolled-back state
                            repair()
                    else:
                        self.recovery_stats[SK.ALLOC_FAULTS] += 1
                    continue
                except OutOfPagesError:
                    self._drop_intents()
                    txn.rollback()
                    self.recovery_stats[SK.ROLLBACKS] += 1
                    raise
                self._committed = False        # the attempt is over
                wall_s = self._last_wall
                if self.mesh is not None:
                    # the wall the monitor reads is agreed (the slowest
                    # rank's, as a GSPMD step's); the tokens are checked equal
                    wall_s = spmd.agree(
                        self.mesh, self._step_no, wall_s,
                        self._emitted if self.ecfg.check_invariants else None)
                if (self._straggler is not None and executed
                        and self._straggler.observe(predicted_s=self._last_dt,
                                                    actual_s=wall_s)):
                    self._requeue_stragglers()
                return executed
            raise RuntimeError(
                f"step {self._step_no}: {_MAX_STEP_ATTEMPTS} fault-recovery "
                f"attempts exhausted")

    def _begin_txn(self) -> StepTxn:
        """Open the step transaction: the common participants through
        ``begin_step_txn`` plus the engine-local view, every attribute the
        JAX engine's ``_begin_txn`` captures.

        Device state: JAX restores its immutable cache and pools by
        reference.  The port writes them in place -- the slot plane's
        merge too, into the same leaves -- so it saves the same
        references (and the cache's leaf map) and relies on the commit
        point: before ``_commit`` an attempt writes no page of the pools
        and no slot of the cache, and no fault point follows it, so the
        references restore every page and slot bit for bit.  Every graph
        replay (and every upload into a graph's static input) comes after
        ``_commit``, so an aborted attempt leaves those buffers as they
        were too; the step graphs are captured against the pools and the
        leaves, which a restore rebinds to the same objects (each call of
        a graph checks it).

        Port-only state: the block-table mirror ``_bt_host`` is deep
        copied (rows are rewritten in place); ``_bt_cache`` is the
        ``allocator.version`` that ``_bt_dev`` holds, which rolls back
        with the allocator; ``_decode_state`` (the cohort key of the
        decode graph's buffer) is replaced wholesale per step; the
        ``_pending_*`` maps carry ``Transfer``s, shared by reference like
        their entries (a re-drain lands an entry once, ``_land``).  Not
        state: ``_link._held`` holds pinned sources until their copies
        pass, whichever attempt made them; ``phase_stats`` and ``wall``
        are measured time, spent by an aborted attempt all the same; and
        ``prefill_rounds``/``decode_steps``/``prefill_tokens``/
        ``prefill_grid_tokens``/``prefill_rounds_by_rows`` move only
        after the commit."""
        txn = begin_step_txn(
            scheduler=self.sched, allocator=self.allocator,
            store=self.swap_store,
            requests=self.sched.waiting + self.sched.running)
        cache = dict(self.cache) if self.cache is not None else None
        pools = (self.k_pools, self.v_pools) if self._pooled else None
        slot_of, free_slots = dict(self.slot_of), list(self.free_slots)
        token_ids = {k: list(v) for k, v in self.token_ids.items()}
        outputs = {k: list(v) for k, v in self.outputs.items()}
        page_keys = dict(self._page_keys_of)
        page_tokens = dict(self._page_tokens_of)
        skip = dict(self._prefix_skip)
        bt_cache = self._bt_cache
        # deep copy: the delta rebuild mutates the mirror in place
        bt_host = np.array(self._bt_host) \
            if self._bt_host is not None else None
        decode_state = self._decode_state   # replaced wholesale per step
        pending = OrderedDict(self._pending_swaps)
        demotes = OrderedDict(self._pending_demotes)
        runs = OrderedDict(self._pending_runs)
        scalars = (self._tier_swap_s, self._carry_swap_s,
                   self._carry_out, self.now)
        stats = dict(self.swap_stats)
        nlogs = len(self.batch_logs)

        def restore() -> None:
            self.cache = dict(cache) if cache is not None else None
            if pools is not None:
                self.k_pools, self.v_pools = pools
            self.slot_of, self.free_slots = dict(slot_of), list(free_slots)
            self.token_ids = {k: list(v) for k, v in token_ids.items()}
            self.outputs = {k: list(v) for k, v in outputs.items()}
            self._page_keys_of = dict(page_keys)
            self._page_tokens_of = dict(page_tokens)
            self._prefix_skip = dict(skip)
            self._bt_cache = bt_cache
            self._bt_host = bt_host
            self._decode_state = decode_state
            self._pending_swaps = OrderedDict(pending)
            self._pending_demotes = OrderedDict(demotes)
            self._pending_runs = OrderedDict(runs)
            (self._tier_swap_s, self._carry_swap_s,
             self._carry_out, self.now) = scalars
            self.swap_stats = dict(stats)
            del self.batch_logs[nlogs:]

        txn.add(restore)
        return txn

    def _requeue_stragglers(self) -> None:
        """``StragglerMonitor`` flagged the step (measured wall far past
        the cost model's dt): requeue every running request through the
        scheduler's preemption path so the next batch re-plans from a
        clean slate.  Swap charges are owed to the next executed batch,
        like an empty-admission round's."""
        self.recovery_stats[SK.STRAGGLER_REQUEUES] += 1
        for victim in list(self.sched.running):
            self.sched._preempt(victim)
            s, o = self._handle_preempted(victim)
            self._carry_swap_s += s
            self._carry_out += o

    def _handle_preempted(self, victim: Request) -> Tuple[float, int]:
        """Free (or swap out) one full-preemption victim; returns the
        (virtual swap time, swap-out count) owed to the batch."""
        if victim.suspended:
            m = victim.swap_out_m   # device-resident portion only
            swapper = (self._swap_out_paged if self._pooled
                       else self._swap_out)
            if swapper(victim):      # False: store full, fell back
                return self._swap_time(m), 1
        else:
            if self._pooled:
                self.swap_store.discard_runs(victim.rid)
                self._purge_pending_runs(victim.rid)
            self._release(victim.rid)
        return 0.0, 0

    def _step_attempt(self) -> int:
        """One attempt at the current step (see ``step``): preempt (tail
        sheds first, then full preemptions), restore swapped re-admissions,
        claim/attach/allocate, commit, price, then run the batch's prefill
        rounds and its decode step."""
        t0 = time.perf_counter()
        ps = self.phase_stats
        self.allocator.now = self.now   # replacement-policy clock
        with span(ps, spans.SCHEDULE):
            batch = self.sched.get_next_batch()
        swap_s = 0.0
        num_swap_out = num_swap_in = 0
        # page-level partial preemptions first: chronologically they
        # precede any later FULL preemption of the same victim, and the
        # tail pages must be snapshotted before the remainder is
        with span(ps, spans.PREEMPT):
            for r, npages, n_tokens, mode in batch.partial_preempted:
                if not r.running:
                    # the victim was ALSO fully preempted later this
                    # round.  A swap-mode shed folds into the full suspend
                    # (whose snapshot covers the whole table, tail
                    # included) but keeps its per-run charge, as the
                    # simulator does; a recompute-mode shed must still
                    # come off the table so the full snapshot matches
                    # suspended_m
                    if mode == "swap":
                        swap_s += self._swap_time(n_tokens)
                        num_swap_out += 1
                    else:
                        removed = self.allocator.free_tail(r.rid, npages)
                        if self.ecfg.check_invariants:
                            invariant(removed == n_tokens,
                                      (r.rid, removed, n_tokens))
                    continue
                if self._shed_tail(r, npages, n_tokens, mode):
                    swap_s += self._swap_time(n_tokens)
                    num_swap_out += 1
            for victim in batch.preempted:
                s, o = self._handle_preempted(victim)
                swap_s += s
                num_swap_out += o
        if not batch.items:
            # swap-outs still happened: owe their virtual-time charge to
            # the next executed batch (mirrors the simulator's carry)
            self._carry_swap_s += swap_s
            self._carry_out += num_swap_out
            with span(ps, spans.COMMIT):
                self._commit()      # no write was staged: nothing applies
            with span(ps, spans.DRAIN):
                self._drain_swaps(before_step=self._step_no)
            self.wall += time.perf_counter() - t0
            return 0
        swap_s += self._carry_swap_s
        num_swap_out += self._carry_out
        self._carry_swap_s, self._carry_out = 0.0, 0

        # swap-ins: restore suspended re-admissions before classification
        # so they re-enter as decodes/short prefills, not full refills;
        # partially shed requests restore their tail runs the same way
        with span(ps, spans.SWAP_IN):
            for r, _ in batch.items:
                if r.suspended:
                    swap_s += self._swap_time(r.suspended_m)
                    num_swap_in += 1
                    (self._swap_in_paged if self._pooled
                     else self._swap_in)(r)
                elif r.tail_suspended_m > 0:
                    swap_s += self._swap_time(r.tail_suspended_m)
                    num_swap_in += 1
                    self._swap_in_tail(r)

        # classify + virtual-time the batch up front
        spec = BatchSpec()
        prefill_items: List[Tuple[Request, int]] = []
        decode_items: List[Tuple[Request, int]] = []
        for r, c in batch.items:
            if r.generated > 0 and c == 1 and r.remaining_prefill == 1:
                decode_items.append((r, c))
                spec.decodes.append((c, r.m))
            else:
                prefill_items.append((r, c))
                spec.prefills.append((c, r.m))

        # claim slots + control-plane allocation BEFORE pricing the batch:
        # the prefix attach may PROMOTE host-demoted pages and any
        # allocation may reclaim-and-DEMOTE registry pages, and those
        # host-link charges belong to THIS batch's virtual time
        # (the span's seconds stay in phase_stats when a fault aborts the
        # attempt: time an aborted attempt spent was still spent)
        with span(ps, spans.ATTACH):
            for r, c in prefill_items:
                if r.rid not in self.slot_of:
                    self._claim_slot(r.rid, reset=not self._pooled)
                skip = 0
                if self._pooled:           # prefix sharing maps KV pages
                    if (self.ecfg.prefix_sharing and r.m == 0
                            and not self.allocator.has(r.rid)):
                        skip = self._attach_prefix(r, c)
                    self._prefix_skip[r.rid] = skip
                self.allocator.allocate(r.rid, c - skip)
                if self._pooled:
                    self._cow_guard(r.rid, r.m + skip)
            for r, _ in decode_items:
                self.allocator.allocate(r.rid, 1)
                if self._pooled:
                    self._cow_guard(r.rid, r.m)
        # the commit point: the last fault point is behind; the staged
        # slot resets and restores, run restores, promotions and CoW
        # copies reach the pools and the cache now, before compute
        with span(ps, spans.COMMIT):
            self._commit()
        swap_s += self._tier_swap_s
        self._tier_swap_s = 0.0

        dt = (self.cost_model.batch_time(spec) if self.cost_model else 0.0) \
            + swap_s
        self.now += dt

        # ---- prefills (one packed bucketed call per round) -------------- #
        if prefill_items:
            with span(ps, spans.PREFILL):
                final_tok = (self._run_prefills_paged if self._pooled
                             else self._run_prefills_legacy if self._legacy
                             else self._run_prefills_batched)(prefill_items)
            with span(ps, spans.ACCOUNT):
                for r, c in prefill_items:
                    m_new = r.m + c
                    generated = r.advance(c, self.now)
                    if self._pooled and self.ecfg.prefix_sharing:
                        self._register_prefix(r, m_new)
                    if generated:
                        tok = final_tok[r.rid]
                        self._emitted[self.slot_of[r.rid]] = tok  # repro: allow-txn-coverage(the step's tokens for the ranks' check: reset at every attempt start, written only after the commit point)
                        self.outputs[r.rid].append(tok)
                        if r.finished:
                            self.sched.complete(r)
                            self._release(r.rid)
                        else:
                            self.token_ids[r.rid].append(tok)

        # ---- decodes (one fused step over all slots) -------------------- #
        if decode_items:
            with span(ps, spans.DECODE):
                host = (self._run_decodes_paged if self._pooled
                        else self._run_decodes_batched)(decode_items)
            with span(ps, spans.ACCOUNT):
                for r, c in decode_items:
                    slot = self.slot_of[r.rid]
                    r.advance(c, self.now)
                    tok = int(host[slot])
                    self._emitted[slot] = tok  # repro: allow-txn-coverage(the step's tokens for the ranks' check: reset at every attempt start, written only after the commit point)
                    self.outputs[r.rid].append(tok)
                    if r.finished:
                        self.sched.complete(r)
                        self._release(r.rid)
                    else:
                        self.token_ids[r.rid].append(tok)

        # end-of-step boundary: snapshots enqueued in EARLIER steps have
        # had a full step of compute to overlap their copy; finalize them
        # now (this step's own snapshots stay in flight)
        with span(ps, spans.DRAIN):
            self._drain_swaps(before_step=self._step_no)
        # measured, rank-local: only the straggler monitor reads it, after
        # the ranks of a mesh agree on it (``step``)
        wall_s = time.perf_counter() - t0
        self.wall += wall_s
        self._last_dt, self._last_wall = dt, wall_s   # straggler inputs  # repro: allow-txn-coverage(straggler-monitor inputs describe the attempt that COMMITTED - an aborted attempt never reaches this line)
        with span(ps, spans.ACCOUNT):
            if self.ecfg.check_invariants:
                self.allocator.check_invariants()
                self.swap_store.check_invariants()
                self._check_index_sync(batch)
            kv_used = sum(r.m for r in self.sched.running)
            self.batch_logs.append(BatchLog(
                t_start=self.now - dt, t_end=self.now,
                num_prefill=len(spec.prefills), num_decode=len(spec.decodes),
                tokens=spec.total_tokens, kv_used=kv_used,
                preempted=len(batch.preempted) + len(batch.partial_preempted),
                swapped_out=num_swap_out, swapped_in=num_swap_in,
                swap_s=swap_s, wall_s=wall_s,
                pages_used=self.allocator.table_pages))
        return len(batch.items)

    def _check_index_sync(self, batch) -> None:
        """The allocator's token count is the position book — it must
        track r.m exactly; on the slot plane so must each slot's device
        index."""
        idx = None
        if not self._pooled:
            idx = self.cache["index"].cpu().numpy()  # repro: allow-host-sync(invariant check after the step's own token fetch - (nslots,) int32, the JAX engine's check_invariants default)
        for r, _ in batch.items:
            if r.finished or r.rid not in self.slot_of:
                continue
            nt = (self.allocator.table(r.rid).num_tokens
                  if self.allocator.has(r.rid) else 0)
            invariant(nt == r.m, (r.rid, nt, r.m))
            if idx is not None:
                slot = self.slot_of[r.rid]
                invariant(idx[slot] == r.m, (r.rid, int(idx[slot]), r.m))

    # ------------------------------------------------------------------ #
    def run(self, requests: Sequence[Request],
            max_batches: int = 100_000) -> "EngineResult":
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        i = 0
        for _ in range(max_batches):
            while i < len(pending) and pending[i].arrival <= self.now + 1e-12:
                self.submit(pending[i])
                i += 1
            if not self.sched.has_work():
                if i >= len(pending):
                    break
                self.now = pending[i].arrival
                continue
            executed = self.step()
            if executed == 0:
                if i < len(pending):     # blocked until the next arrival
                    self.now = max(self.now, pending[i].arrival)
                    continue
                raise RuntimeError(
                    "engine deadlock: work remains but nothing schedulable")
        else:
            raise RuntimeError("engine did not converge")
        self._drain_swaps()
        if self.ecfg.check_invariants:
            invariant(not (self._pending_swaps or self._pending_demotes
                           or self._pending_runs), "transfers left in flight")
            invariant(len(self.swap_store) == 0,
                      ("swap store leaked rids",
                       self.swap_store.suspended_rids))
        sim = SimResult(requests=list(requests), batches=self.batch_logs,
                        num_preemptions=self.sched.num_preemptions,
                        num_partial_preempts=self.sched.num_partial_preempts,
                        num_swaps=self.sched.num_swaps)
        return EngineResult(outputs=dict(self.outputs), metrics=sim,
                            wall_time=self.wall,
                            swap_stats=dict(self.swap_stats),
                            num_compiles=self.num_compiles,
                            recovery_stats=dict(self.recovery_stats),
                            phase_stats=dict(self.phase_stats))


@dataclass
class EngineResult:
    outputs: Dict[int, List[int]]
    metrics: SimResult
    wall_time: float
    swap_stats: Dict[str, float] = field(default_factory=dict)
    num_compiles: int = 0
    # abort history (rollbacks, alloc faults, integrity failures,
    # degraded recomputes, straggler requeues, aborted wall)
    recovery_stats: Dict[str, float] = field(default_factory=dict)
    # host seconds by phase, one key a span (``serving.spans.KEY``)
    phase_stats: Dict[str, float] = field(default_factory=dict)


# --------------------------------------------------------------------- #
# reference generation (no scheduler) — the parity oracle
# --------------------------------------------------------------------- #


@torch.no_grad()
def generate_reference(cfg: ModelConfig, params: Any, prompt: Sequence[int],
                       num_tokens: int, *, cache_len: int,
                       impl: str = "reference", moe_impl: str = "dense",
                       device: str = "cuda") -> List[int]:
    """Greedy generation of one request: full prefill + sequential decode
    through the dense-cache attention of ``models`` (no pages).
    ``impl="flash"`` runs the prefill on the flash-attention kernel (its
    decode takes the reference branch, as in JAX); ``impl="paged"`` the
    decode on the paged decode kernel over the contiguous cache.  An MoE
    model's layers take the ``moe_impl`` dispatch.  Sampling is on the
    device; only token ids reach the host."""
    vocab = cfg.vocab_size
    toks = torch.tensor([list(prompt)], dtype=torch.long, device=device)
    logits, cache = M.prefill(cfg, params, {"tokens": toks},
                              cache_len=cache_len, impl=impl,
                              moe_impl=moe_impl)
    cur = torch.argmax(logits[:, :vocab], dim=-1)
    # repro: allow-host-sync(the parity oracle outside the serving loop - one greedy id a step must reach the host)
    out: List[int] = [int(cur[0])]
    for _ in range(num_tokens - 1):
        logits, cache = M.decode_step(cfg, params, cur, cache, impl=impl,
                                      moe_impl=moe_impl)
        cur = torch.argmax(logits[:, :vocab], dim=-1)
        out.append(int(cur[0]))  # repro: allow-host-sync(the parity oracle - as above)
    return out
