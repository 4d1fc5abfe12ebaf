"""The port's step transactions against its in-place device state, on the
CPU.  The JAX engine rolls its cache and pools back by restoring
references to immutable arrays; the port's pools and slots are written in
place, so it defers every write that precedes a fault point to one commit
point (``Engine._commit``).  For each kind of such write (a claimed
slot's reset, a slot swap-in, a full page-run restore, a tail restore, a
prefix promotion, a copy-on-write page copy), in a step where it targets
a page or slot that was live at batch start (in a block table, held by
the prefix registry, or a request's slot):

* a ``FaultError`` injected after the write rolls the attempt back, and
  every live page and slot is ``torch.equal`` to its batch-start bytes;
  the retry then commits, and the device state after every step equals a
  fault-free twin engine's;
* an ``IntegrityError`` after the write, whose repair degrades a request
  to recompute so that the retry plans another batch, still serves the
  fault-free tokens.

Plus ``StepTxn`` over the port's participants and the commit point's
guards.  This file imports neither JAX nor the JAX package."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (PagedAllocator, Request, TheoreticalCostModel,
                              get_hardware, make_scheduler)
from repro_torch.core.invariants import InvariantError
from repro_torch.data import zipf_shared_prefix
from repro_torch.models import model as M
from repro_torch.serving import (Engine, EngineConfig, KVSwapStore,
                                 generate_reference)
from repro_torch.serving.faults import FaultError, IntegrityError
from repro_torch.serving.txn import begin_step_txn

torch.set_num_threads(2)

CACHE_LEN = 64


@pytest.fixture(scope="module")
def dense():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    return cfg, M.init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def rwkv():
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              dtype="float32")
    return cfg, M.init_params(cfg, 0, device="cpu")


def engine(model, sched, M_kv, S=128, preempt_mode="recompute",
           partial=False, **ekw):
    cfg, params = model
    ekw = dict(dict(nslots=4, cache_len=CACHE_LEN, chunk=16, page_size=8,
                    plane="paged"), **ekw)
    return Engine(cfg, params,
                  make_scheduler(sched, M_kv, S=S, replacement="srf",
                                 preempt_mode=preempt_mode,
                                 partial_preempt=partial),
                  EngineConfig(**ekw),
                  cost_model=TheoreticalCostModel(cfg,
                                                  get_hardware("tpu_v5e")),
                  device="cpu")


def mixed_requests(vocab, n, seed, lo, hi, olo, ohi):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        I, O = int(rs.randint(lo, hi)), int(rs.randint(olo, ohi))
        out.append(Request(rid=i, input_len=I, output_len=O, arrival=0.0,
                           prompt=rs.randint(0, vocab, size=I).tolist()))
    return out


#: write kind -> (model, engine settings, workload): a workload on which
#: the kind's write lands on a page or slot live at batch start
SCENARIOS = {
    # a full suspend restored into pages a victim freed in the same step
    "run_restore": ("dense", dict(sched="vllm", M_kv=60,
                                  preempt_mode="swap"),
                    lambda v: mixed_requests(v, 5, 0, 8, 25, 3, 9)),
    # a shed tail restored into pages another victim's shed freed
    "tail_restore": ("dense", dict(sched="sarathi_cs", M_kv=80,
                                   preempt_mode="swap", partial=True),
                     lambda v: mixed_requests(v, 8, 4, 4, 28, 3, 16)),
    # a host-tier page promoted into a reclaimed registry page
    "promotion": ("dense", dict(sched="vllm", M_kv=256, S=512,
                                cache_policy="break_even",
                                cache_demotion=True),
                  lambda v: zipf_shared_prefix(n=16, num_groups=6,
                                               page_size=8, seed=1,
                                               vocab=v)),
    # a fresh claim of the slot a victim released in the same step
    "slot_reset": ("rwkv", dict(sched="sarathi_cs", M_kv=40, page_size=1,
                                plane="batched"),
                   lambda v: mixed_requests(v, 8, 3, 8, 30, 3, 12)),
    # a swapped-out request restored into a victim's slot
    "slot_swap_in": ("rwkv", dict(sched="sarathi_cs", M_kv=40, page_size=1,
                                  plane="batched", preempt_mode="swap"),
                     lambda v: mixed_requests(v, 8, 3, 8, 30, 3, 12)),
}


def device_state(eng):
    """A copy of every page of the pools, or every leaf of the slots."""
    if eng.k_pools is not None:
        return {"k": eng.k_pools.clone(), "v": eng.v_pools.clone()}
    return {k: v.clone() for k, v in eng.cache.items()}


def live_sets(eng):
    a = eng.allocator
    pages = {p for t in a._tables.values() for p in t.pages} | set(a._pinned)
    return pages, set(eng.slot_of.values())


def assert_live_equal(eng, before, live):
    pages, slots = live
    if eng.k_pools is not None:
        assert pages
        for p in sorted(pages):
            assert torch.equal(eng.k_pools[:, p], before["k"][:, p]), p
            assert torch.equal(eng.v_pools[:, p], before["v"][:, p]), p
    else:
        assert slots
        for k, leaf in eng.cache.items():
            ax = 0 if leaf.dim() == 1 else 1
            for s in sorted(slots):
                assert torch.equal(leaf.select(ax, s),
                                   before[k].select(ax, s)), (k, s)


def assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


class Injector:
    """Raise ``inject`` at the commit point of the first attempt whose
    pending writes include ``kind`` on a page or slot live at batch start
    (every write of the attempt is staged by then: the fault comes after
    it), and check, when the retry opens its transaction, that the
    rollback left every live page and slot as it was at batch start."""

    def __init__(self, eng, kind, inject):
        self.eng, self.kind, self.inject = eng, kind, inject
        self.fired = self.checked = False
        self._begin, self._commit = eng._begin_txn, eng._commit
        eng._begin_txn, eng._commit = self.begin, self.commit

    def begin(self):
        if self.fired and not self.checked:
            assert_live_equal(self.eng, self.before, self.live)
            if self.inject is fault:   # (a repair may change the books)
                assert live_sets(self.eng) == self.live
            self.checked = True
        self.before, self.live = device_state(self.eng), live_sets(self.eng)
        return self._begin()

    def _hit(self):
        pages, slots = self.live
        return [(p, s) for kind, p, s, _ in self.eng._intents
                if kind == self.kind
                and (pages.intersection(p) or slots.intersection(s))]

    def commit(self):
        hit = None if self.fired else self._hit()
        if hit:
            self.fired = True
            raise self.inject(self.eng, self.kind, hit)
        return self._commit()


def fault(eng, kind, hit):
    return FaultError(f"injected after a {kind} write of {hit}")


def integrity(eng, kind, hit):
    """An ``IntegrityError`` whose repair degrades a request, so that the
    retried step plans another batch: a restore's owner drops its
    snapshot (the engine's own repairs), any other write requeues a
    running request (with none running, the host tier a promotion read
    is forgotten)."""
    pages, slots = hit[0]
    owner = next((rid for rid, s in eng.slot_of.items() if s in slots),
                 None) if slots else next(
        (rid for rid, t in eng.allocator._tables.items()
         if set(pages) & set(t.pages)), None)
    r = next((q for q in eng.sched.waiting + eng.sched.running
              if q.rid == owner), None)

    def requeue():                       # on the rolled-back state
        if eng.sched.running:
            victim = eng.sched.running[-1]
            eng.sched._preempt(victim)
            eng._handle_preempted(victim)
        else:                            # the promoted page recomputes
            for key in list(eng.swap_store._prefixes):
                eng.swap_store.pop_prefix(key)

    repair = {"run_restore": lambda: eng._drop_runs_repair(r, claim=True),
              "tail_restore": lambda: eng._drop_runs_repair(r, claim=False),
              "slot_swap_in": lambda: eng._drop_snapshot_repair(r)}.get(
                  kind, lambda: requeue)()
    return IntegrityError(f"injected after a {kind} write of {hit}",
                          repairs=[repair])


def _plan(b):
    d = dataclasses.asdict(b)
    d.pop("wall_s")
    return d


def lockstep(eng, twin, reqs, twin_reqs, compare=True, steps=500):
    for r, q in zip(reqs, twin_reqs):
        eng.submit(r)
        twin.submit(q)
    for _ in range(steps):
        if not (eng.sched.has_work() or twin.sched.has_work()):
            break
        eng.step()
        twin.step()
        if compare:
            assert_state_equal(device_state(eng), device_state(twin))
    assert not eng.sched.has_work() and not twin.sched.has_work()


def scenario(kind, dense, rwkv, inject):
    which, kw, work = SCENARIOS[kind]
    model = dense if which == "dense" else rwkv
    kw = dict(kw)
    args = (kw.pop("sched"), kw.pop("M_kv"))
    eng, twin = engine(model, *args, **kw), engine(model, *args, **kw)
    vocab = model[0].vocab_size
    inj = Injector(eng, kind, inject)
    return eng, twin, inj, work(vocab), work(vocab)


@pytest.mark.parametrize("kind", list(SCENARIOS))
def test_fault_after_write_rolls_live_state_back(dense, rwkv, kind):
    eng, twin, inj, reqs, twin_reqs = scenario(kind, dense, rwkv, fault)
    lockstep(eng, twin, reqs, twin_reqs)
    assert inj.fired and inj.checked
    assert eng.recovery_stats["alloc_faults"] == 1
    assert eng.outputs == twin.outputs
    assert eng.batch_logs and [b.t_end for b in eng.batch_logs] == \
        [b.t_end for b in twin.batch_logs]


@pytest.mark.parametrize("kind", list(SCENARIOS))
def test_integrity_rollback_replans_and_serves_fault_free_tokens(
        dense, rwkv, kind):
    eng, twin, inj, reqs, twin_reqs = scenario(kind, dense, rwkv, integrity)
    lockstep(eng, twin, reqs, twin_reqs, compare=False)
    assert inj.fired and inj.checked
    rec = eng.recovery_stats
    assert (rec["integrity_failures"], rec["degraded_recomputes"]) == (1, 1)
    # the retry planned another batch than the fault-free run's
    assert [_plan(b) for b in eng.batch_logs] != \
        [_plan(b) for b in twin.batch_logs]
    assert eng.outputs == twin.outputs
    assert len(eng.swap_store) == 0 and not eng._pending_runs \
        and not eng._pending_swaps


def _cow_engine(dense):
    """Two requests; request 0's two prompt pages are registered (and
    pinned), request 1 holds the pages the next allocation takes once it
    is released."""
    eng = engine(dense, "vllm", 400, S=512, nslots=8)
    vocab = dense[0].vocab_size
    reqs = [Request(rid=0, input_len=16, output_len=6, arrival=0.0,
                    prompt=list(range(100, 116))),
            Request(rid=1, input_len=20, output_len=4, arrival=0.0,
                    prompt=np.random.RandomState(9).randint(
                        0, vocab, size=20).tolist())]
    for r in reqs:
        eng.submit(r)
    eng.step()                           # both prompts prefill
    return eng, reqs


@pytest.mark.parametrize("inject", ["fault", "integrity"])
def test_cow_copy_into_a_freed_live_page_rolls_back(dense, inject):
    """The copy-on-write copy, which the scheduler's own plans never
    reach (only full prompt pages are shared): an attempt releases
    request 1 and forces a write into request 0's pinned page, whose copy
    lands in a page request 1 held at batch start; the fault after it
    rolls everything back, and the retry's copy equals a twin's."""
    eng, reqs = _cow_engine(dense)
    twin, _ = _cow_engine(dense)
    pinned = eng.allocator.table(0).pages[1]
    held = set(eng.allocator.table(1).pages)
    before, live = device_state(eng), live_sets(eng)
    real = eng._step_attempt
    calls = []

    def attempt():
        calls.append(len(calls))
        if len(calls) == 2:              # the retry: all rolled back
            assert_live_equal(eng, before, live)
            assert eng.allocator.table(0).pages[1] == pinned
        if len(calls) == 1 or inject == "fault":
            eng._release(1)
        eng._cow_guard(0, 12)            # mid-page write into the pin
        (kind, pages, _, _), = eng._intents
        assert kind == "cow_copy" and set(pages) <= held
        if len(calls) == 1:
            if inject == "fault":
                raise FaultError("injected after the CoW write")
            r1 = reqs[1]

            def requeue():               # degrade request 1: recompute
                eng.sched._preempt(r1)
                eng._handle_preempted(r1)
            raise IntegrityError("injected after the CoW write",
                                 repairs=[requeue])
        eng._commit()
        return 1

    eng._step_attempt = attempt
    eng.step()
    eng._step_attempt = real
    assert len(calls) == 2 and eng.recovery_stats["rollbacks"] == 1
    new = eng.allocator.table(0).pages[1]
    assert new != pinned and new in held
    assert torch.equal(eng.k_pools[:, new], before["k"][:, pinned])
    assert torch.equal(eng.k_pools[:, pinned], before["k"][:, pinned])
    if inject == "fault":
        twin._release(1)
        twin._cow_guard(0, 12)
        assert_state_equal(device_state(eng), device_state(twin))
        return
    for _ in range(50):
        if not eng.sched.has_work():
            break
        eng.step()
    cfg, params = dense
    for r in reqs:
        assert eng.outputs[r.rid] == generate_reference(
            cfg, params, r.prompt, r.output_len, cache_len=CACHE_LEN,
            device="cpu"), r.rid


def test_step_txn_restores_every_participant():
    """``tests/test_chaos.py::test_step_txn_restores_every_participant``
    over the port's allocator, store, scheduler and request."""
    alloc = PagedAllocator(num_pages=8, page_size=2)
    store = KVSwapStore()
    sched = make_scheduler("vllm", 64, S=128)
    r = Request(rid=0, input_len=4, output_len=4, arrival=0.0,
                prompt=[1, 2, 3, 4])
    sched.add_request(r)
    txn = begin_step_txn(scheduler=sched, allocator=alloc, store=store,
                         requests=[r])
    alloc.allocate(0, 6)
    store.put(0, {"k": np.zeros(4, np.float32)}, [1, 2], 2)
    r.m, r.generated, r.running = 3, 2, True
    sched.waiting.clear()
    sched.running.append(r)
    txn.rollback()
    assert alloc.free_pages == 8
    assert len(store) == 0
    assert (r.m, r.generated, r.running) == (0, 0, False)
    assert sched.waiting == [r] and sched.running == []
    with pytest.raises(RuntimeError, match="twice"):
        txn.rollback()


def test_fault_points_after_the_commit_are_invariant_violations(dense):
    """After the commit point no fault may be raised: an allocation
    (the fault hook's site), a deferred write or a rollback there fails
    loudly instead of leaving a hole in the device state."""
    from repro_torch.serving.faults import FaultSpec
    eng = engine(dense, "vllm", 60, faults=FaultSpec(seed=0, p_alloc=1e-9))
    eng._intents, eng._committed = [], False
    eng._alloc_fault_hook(1)             # before the commit: allowed
    eng._commit()
    with pytest.raises(InvariantError, match="commit point"):
        eng._alloc_fault_hook(1)
    with pytest.raises(InvariantError, match="commit point"):
        eng._write("cow_copy", lambda: None, pages=(0,))
    with pytest.raises(InvariantError, match="commit point"):
        eng._drop_intents()


def test_gather_of_a_pending_write_target_is_refused(dense):
    """A pre-commit gather must not read a page that a pending intent of
    the same attempt writes: it would see the batch-start bytes, not the
    ones the attempt means."""
    eng = engine(dense, "vllm", 60)
    eng._intents, eng._committed = [], False
    eng._restore_pages([3], {"k": eng.k_pools[:, [5]].clone(),
                             "v": eng.v_pools[:, [5]].clone()})
    with pytest.raises(InvariantError, match="pending"):
        eng._gather_pages_device([2, 3])
    eng._gather_pages_device([2])
    eng._drop_intents()


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plane", ["pooled", "slot"])
def test_chip_smoke_rollback_cases_on_cpu(plane, dtype):
    """``chip_smoke.py`` phase 17's cases at reduced size on the CPU: every
    write kind of the plane staged into a victim's page or slot, the last
    allocation faulted, live state bit-equal after the rollback and the
    retry bit-equal to a fault-free step."""
    cs = _chip_smoke()
    arch = "tinyllama-1.1b" if plane == "pooled" else "rwkv6-7b"
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    ecfg = EngineConfig(nslots=4, cache_len=CACHE_LEN, chunk=16,
                        page_size=8, plane="paged" if plane == "pooled"
                        else "batched")
    fn = cs.rollback_pooled if plane == "pooled" else cs.rollback_slot
    out = fn(torch, cfg, ecfg, 256, "cpu")
    assert out["bytes_checked"] > 0
