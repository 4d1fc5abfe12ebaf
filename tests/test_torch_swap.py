"""The port's swap data plane on the CPU: the host store and its
transfers, mirroring the JAX package's own tests of the same paths
(``tests/test_cache_replacement.py``, ``tests/test_paged_plane.py``).

On the CPU no stream exists and every copy is synchronous, so these tests
hold the bookkeeping (tilings, fallbacks, seals, the decode cohort) and
the parity of the asynchronous path with the synchronous one.  The stream
ordering and the buffer lifetimes can fail only on a card:
``tests/test_torch_cuda_swap.py`` and ``chip_smoke.py`` phase 13 hold
them there.  This file imports neither JAX nor the JAX package."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import Request, TheoreticalCostModel, get_hardware
from repro_torch.core import make_scheduler
from repro_torch.core.scheduler import Batch
from repro_torch.data import zipf_shared_prefix
from repro_torch.models import model as M
from repro_torch.serving import (Engine, EngineConfig, KVSwapStore,
                                 generate_reference)
from repro_torch.serving.host_copy import (HostLink, gather_pages,
                                           gather_slot, restore_pages,
                                           restore_slot)
from repro_torch.serving.paged_plane import init_pools
from repro_torch.serving.swap_store import flip_bit, seal_entry, verify_entry

torch.set_num_threads(2)

CACHE_LEN = 64


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    return cfg, M.init_params(cfg, 0, device="cpu")


def build(model, M_kv=400, nslots=4, page_size=8, sched="vllm", S=512,
          preempt_mode="recompute", partial_preempt=False, **ekw):
    cfg, params = model
    sch = make_scheduler(sched, M_kv, S=S, replacement="srf",
                         preempt_mode=preempt_mode,
                         partial_preempt=partial_preempt)
    return Engine(cfg, params, sch,
                  EngineConfig(nslots=nslots, cache_len=CACHE_LEN, chunk=16,
                               plane="paged", page_size=page_size, **ekw),
                  cost_model=TheoreticalCostModel(cfg,
                                                  get_hardware("tpu_v5e")),
                  device="cpu")


def prompt_request(model, rid, n, seed, output_len=4):
    vocab = model[0].vocab_size
    return Request(rid=rid, input_len=n, output_len=output_len, arrival=0.0,
                   prompt=np.random.RandomState(seed).randint(
                       0, vocab, size=n).tolist())


def finish(eng, r, steps=50):
    for _ in range(steps):
        if r.finished:
            break
        eng.step()
    assert r.finished


def reference(model, r):
    cfg, params = model
    return generate_reference(cfg, params, r.prompt, r.output_len,
                              cache_len=CACHE_LEN, device="cpu")


def zipf_requests(vocab):
    return zipf_shared_prefix(n=24, num_groups=6, page_size=8, seed=3,
                              vocab=vocab)


def partial_requests(vocab):
    rs = np.random.RandomState(2)
    out = []
    for i in range(8):
        I, O = int(rs.randint(4, 28)), int(rs.randint(3, 16))
        out.append(Request(rid=i, input_len=I, output_len=O, arrival=0.0,
                           prompt=rs.randint(0, vocab, size=I).tolist()))
    return out


@pytest.mark.parametrize("workload", ["demotion", "partial_swap"])
def test_async_swap_parity_with_sync(model, workload):
    """The asynchronous path (fresh gathers, copies finalized at the drain
    boundaries) against the synchronous one ``async_swap=False`` selects:
    the same tokens, the same counts, the same makespan, and host-tier
    entries of identical bytes, held as numpy (``tests/
    test_cache_replacement.py::test_async_demotion_parity_with_sync``)."""
    vocab = model[0].vocab_size

    def run(async_swap):
        if workload == "demotion":
            eng = build(model, M_kv=256, cache_policy="break_even",
                        cache_demotion=True, async_swap=async_swap)
            reqs = zipf_requests(vocab)
        else:
            eng = build(model, M_kv=72, S=128, sched="sarathi_cs",
                        preempt_mode="swap", partial_preempt=True,
                        async_swap=async_swap)
            reqs = partial_requests(vocab)
        return eng.run(reqs), eng

    res_s, eng_s = run(False)
    res_a, eng_a = run(True)
    assert res_a.outputs == res_s.outputs
    counts = {k: v for k, v in res_s.swap_stats.items()
              if not k.startswith("wall_")}
    assert {k: res_a.swap_stats[k] for k in counts} == counts
    assert res_a.metrics.makespan == res_s.metrics.makespan
    key = "demotions" if workload == "demotion" else "swap_outs"
    assert counts[key] > 0
    assert not (eng_a._pending_demotes or eng_a._pending_runs)
    assert eng_a.swap_store.num_prefix_entries \
        == eng_s.swap_store.num_prefix_entries
    for k, ent_a in eng_a.swap_store._prefixes.items():
        ent_s = eng_s.swap_store._prefixes[k]
        assert ent_a.tokens == ent_s.tokens
        assert isinstance(ent_a.kv["k"], np.ndarray)
        np.testing.assert_array_equal(ent_a.kv["k"], ent_s.kv["k"])
        np.testing.assert_array_equal(ent_a.kv["v"], ent_s.kv["v"])
        assert ent_a.nbytes == ent_s.nbytes and ent_a.crc == ent_s.crc


def test_shed_store_full_mid_stack_folds_stored_runs_back(model):
    """When a second (lower) tail run overflows the store, the run already
    stored above it is unrestorable across the gap and folds back to
    recompute too (``tests/test_paged_plane.py``)."""
    cfg = model[0]
    run_bytes = 2 * cfg.num_layers * 8 * cfg.num_kv_heads * cfg.head_dim_ * 4
    eng = build(model, preempt_mode="swap", partial_preempt=True,
                swap_bytes=int(run_bytes * 1.5))
    r = prompt_request(model, 0, 32, seed=0)
    eng.submit(r)
    eng.step()                                     # full prefill, m=32
    r.partial_preempt(8, mode="swap")              # [24, 32): fits
    eng.sched.num_swaps += 1
    assert eng._shed_tail(r, 1, 8, "swap") is True
    r.partial_preempt(8, mode="swap")              # [16, 24): overflows
    eng.sched.num_swaps += 1
    assert eng._shed_tail(r, 1, 8, "swap") is False
    assert r.tail_suspended_m == 0 and r.swaps == 0
    assert not eng.swap_store.has_runs(0) and not eng._pending_runs
    assert eng.sched.num_swaps == 0
    eng.swap_store.check_invariants()
    assert r.remaining_prefill == 32 - 16 + 1      # refill covers the gap
    finish(eng, r)
    assert eng.outputs[0] == reference(model, r)


def test_shed_then_full_preempt_same_round_merges_snapshot(model):
    """A victim shed and then fully swap-preempted in one round: nothing
    was freed mid-round, so the full snapshot covers the whole table
    (tail included) as ONE run, and the restore brings back exactly
    suspended_m tokens."""
    eng = build(model, preempt_mode="swap", partial_preempt=True)
    r = prompt_request(model, 0, 32, seed=1)
    eng.submit(r)
    eng.step()                                     # m=32, one token out
    r.partial_preempt(8, mode="swap")
    eng.sched.num_swaps += 1
    r.preempt(mode="swap")                         # folds tail into full
    eng.sched.num_swaps += 1
    eng.sched.running.remove(r)
    assert r.suspended and r.suspended_m == 32 and r.swap_out_m == 24
    assert eng._swap_out_paged(r) is True
    assert eng.swap_store.run_tokens(0) == 32
    eng.sched.running.append(r)
    r.running = True
    eng._swap_in_paged(r)
    assert r.m == 32 and not r.suspended
    finish(eng, r)
    assert eng.outputs[0] == reference(model, r)


def test_recompute_shed_then_swap_preempt_same_round(model):
    """A recompute-mode shed followed by a swap-mode full preemption of
    the same victim in one round: the shed tokens come off the block
    table before the full snapshot, so the stored run covers suspended_m
    tokens, not the whole former table."""
    eng = build(model, preempt_mode="auto", partial_preempt=True)
    r = prompt_request(model, 0, 32, seed=2)
    eng.submit(r)
    eng.step()
    r.partial_preempt(8, mode="recompute")
    r.preempt(mode="swap")
    eng.sched.num_swaps += 1
    eng.sched.running.remove(r)
    eng.sched.waiting.append(r)
    assert r.suspended_m == 24
    crafted = Batch(items=[], preempted=[r],
                    partial_preempted=[(r, 1, 8, "recompute")])
    orig = eng.sched.get_next_batch
    eng.sched.get_next_batch = lambda: crafted
    eng.step()                 # the replay loop frees the shed tail
    eng.sched.get_next_batch = orig
    assert eng.swap_store.run_tokens(0) == 24
    finish(eng, r)
    assert eng.outputs[0] == reference(model, r)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_page_run_round_trip_through_the_store_is_bit_exact(model, dtype):
    """A page run gathered from the pools, copied to the host, stored,
    CRC-sealed and verified, then restored into OTHER page ids gives the
    same bits (bf16 travels as its raw int16 bits, never cast); one
    flipped bit is caught by ``verify_entry``."""
    cfg = dataclasses.replace(model[0], dtype=str(dtype).split(".")[1])
    kp, vp = init_pools(cfg, 12, 8, device="cpu")
    g = torch.Generator().manual_seed(0)
    for p in (kp, vp):
        p.copy_(torch.randn(p.shape, generator=g).to(dtype))
    src, dst = [3, 7, 1], [10, 2, 5]
    want = gather_pages(kp, vp, torch.tensor(src))
    link = HostLink("cpu")
    xfer = link.start(gather_pages(kp, vp, link.ids(src)))
    kp[:, src] = 0                         # the source pages are reused
    vp[:, src] = 0
    host = link.finish(xfer)
    assert host["k"].dtype == (np.int16 if dtype == torch.bfloat16
                               else np.float32)
    store = KVSwapStore()
    entry = store.put_run(0, start=0, num_tokens=24, kv=host)
    assert entry.nbytes == 2 * want["k"].numel() * want["k"].element_size()
    seal_entry(entry)
    assert entry.crc is not None and verify_entry(entry)
    restore_pages(kp, vp, link.ids(dst),
                  {k: link.to_device(v, kp) for k, v in entry.kv.items()})
    assert kp.dtype == dtype
    assert torch.equal(kp[:, dst].view(torch.uint8),
                       want["k"].view(torch.uint8))
    assert torch.equal(vp[:, dst].view(torch.uint8),
                       want["v"].view(torch.uint8))
    assert flip_bit(entry.kv) and not verify_entry(entry)
    store.pop_runs(0)
    store.check_invariants()


def test_slot_round_trip_covers_every_leaf():
    """One RWKV6 slot (``index``, ``S``, ``x_tm``, ``x_cm``) gathered,
    copied out, overwritten and restored into another slot, bit for bit;
    the other slots keep their state."""
    cfg = get_config("rwkv6-7b").reduced()
    cache = M.init_cache(cfg, 4, CACHE_LEN, device="cpu")
    assert set(cache) == {"index", "S", "x_tm", "x_cm"}
    g = torch.Generator().manual_seed(1)
    for leaf in cache.values():
        leaf.copy_((torch.randn(leaf.shape, generator=g) * 100).to(
            leaf.dtype))
    before = {k: v.clone() for k, v in cache.items()}
    link = HostLink("cpu")
    xfer = link.start(gather_slot(cache, link.ids([2])))
    for leaf in cache.values():            # the slot is reused at once
        leaf[2 if leaf.dim() == 1 else (slice(None), 2)] = 0
    host = link.finish(xfer)
    restore_slot(cache, link.ids([0]),
                 {k: link.to_device(v, cache[k]) for k, v in host.items()})
    for k, v in cache.items():
        ax = 0 if v.dim() == 1 else 1
        assert torch.equal(v.select(ax, 0), before[k].select(ax, 2)), k
        assert torch.equal(v.select(ax, 1), before[k].select(ax, 1)), k


def rwkv_model():
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              dtype="float32")
    return cfg, M.init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("plane", ["pooled", "slot"])
def test_corrupt_snapshot_rolls_back_and_degrades(model, plane):
    """A snapshot whose CRC seal fails at swap-in (one flipped bit) makes
    the step raise ``IntegrityError`` inside its transaction: the attempt
    rolls back, the repair drops the entry and degrades the request to
    recompute, and the retried step refills it, so its tokens stay the
    reference's and nothing is left in the store."""
    if plane == "pooled":
        eng = build(model, preempt_mode="swap")
        mdl = model
    else:
        mdl = rwkv_model()
        cfg, params = mdl
        eng = Engine(cfg, params,
                     make_scheduler("vllm", 400, S=512, replacement="srf",
                                    preempt_mode="swap"),
                     EngineConfig(nslots=4, cache_len=CACHE_LEN, chunk=16,
                                  page_size=8, plane="batched"),
                     cost_model=TheoreticalCostModel(
                         cfg, get_hardware("tpu_v5e")), device="cpu")
    r = prompt_request(mdl, 0, 32, seed=3, output_len=6)
    eng.submit(r)
    eng.step()
    eng.sched._preempt(r)                  # a swap-mode full preemption
    assert r.suspended
    eng._handle_preempted(r)
    eng._drain_swaps()
    if plane == "pooled":
        (entry,) = eng.swap_store.peek_runs(0)
        payload = entry.kv
    else:
        entry = eng.swap_store.peek(0)
        payload = entry.cache
    assert entry.crc is not None and flip_bit(payload)
    swaps = eng.sched.num_swaps
    eng.step()                             # swap-in fails its seal
    rec = eng.recovery_stats
    assert (rec["rollbacks"], rec["integrity_failures"],
            rec["degraded_recomputes"], rec["alloc_faults"]) == (1, 1, 1, 0)
    assert not r.suspended and eng.sched.num_swaps == swaps - 1
    assert len(eng.swap_store) == 0 and not eng._pending_swaps \
        and not eng._pending_runs
    assert eng.swap_stats["swap_ins"] == 0
    finish(eng, r)
    assert eng.outputs[0] == reference(mdl, r)


def test_redrain_after_rollback_keeps_seal_and_flip(model):
    """A rollback restores the pending map, not the entries: an entry
    that the aborted attempt already drained (sealed, and flipped by the
    fault plan) is named again, and draining it again must keep its
    CRC and its flipped bytes (not re-seal them, and not hand back the
    transfer's bytes from before the flip)."""
    eng = build(model, preempt_mode="swap")
    r = prompt_request(model, 0, 32, seed=5)
    eng.submit(r)
    eng.step()
    eng.sched._preempt(r)
    eng._handle_preempted(r)
    saved = type(eng._pending_runs)(eng._pending_runs)   # a txn's capture
    (entry,) = eng.swap_store.peek_runs(0)
    entry.corrupt = True                   # the fault plan's marker
    eng._drain_runs(rid=0)
    crc, k = entry.crc, entry.kv["k"].copy()
    assert crc is not None and not verify_entry(entry)
    eng._pending_runs = saved              # the rollback restores the map
    eng._drain_runs(rid=0)
    assert entry.crc == crc and not verify_entry(entry)
    np.testing.assert_array_equal(entry.kv["k"], k)
    assert not eng._pending_runs


def test_shed_and_restore_keeps_the_cohort_and_refreshes_the_table(model):
    """A decoding request's tail shed and restored between two decode
    steps: its cohort key (rid, slot, m, tokens) is unchanged, so the
    next decode reuses the device-resident tokens and contexts, while
    the page ids have moved; the block table still refreshes through the
    allocator's version bump, and the tokens stay the reference's."""
    eng = build(model, preempt_mode="swap", partial_preempt=True)
    r = prompt_request(model, 0, 16, seed=4, output_len=8)
    eng.submit(r)
    for _ in range(3):                     # prefill, then two decodes
        eng.step()
    assert r.m == 18 and eng._decode_state is not None
    slot = eng.slot_of[0]
    old = list(eng.allocator.table(0).pages)
    key = eng._decode_state["key"]
    r.partial_preempt(2, mode="swap")      # the 2-token tail page
    eng.sched.num_swaps += 1
    assert eng._shed_tail(r, 1, 2, "swap") is True
    eng.allocator.allocate(99, 8)          # a stranger takes the freed page
    eng._swap_in_tail(r)
    eng.allocator.free(99)
    new = list(eng.allocator.table(0).pages)
    assert new[:2] == old[:2] and new[2] != old[2]
    assert tuple(sorted([(0, slot, r.m, len(eng.token_ids[0]))])) == key
    eng.step()                             # a cohort hit: nothing uploaded
    assert eng._bt_host[slot, 2] == new[2]
    finish(eng, r)
    assert eng.outputs[0] == reference(model, r)
    assert eng.swap_stats["swap_outs"] == eng.swap_stats["swap_ins"] == 1
