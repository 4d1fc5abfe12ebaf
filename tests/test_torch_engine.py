"""The port's ``Engine(..., device="cpu")`` against the JAX ``Engine``
(``plane="paged"``) on the same workloads: token-identical outputs, the
same ``BatchLog`` schedule (every field but the measured ``wall_s``),
the same preemption, prefix-hit and swap counts (recompute, swap and
``auto`` preemption, page-level partial preemption, the host demotion
tier), and tokens equal to both packages' ``generate_reference``.  Requests are built from one numpy
spec into each package's own ``Request``."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import Request as JRequest
from repro.core import TheoreticalCostModel as JCost
from repro.core import get_hardware as j_hw
from repro.core import make_scheduler as j_sched
from repro.data.workloads import shared_prefix as j_shared_prefix
from repro.data.workloads import zipf_shared_prefix as j_zipf_shared_prefix
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import generate_reference as j_reference
from repro_torch.core import Request as TRequest
from repro_torch.core import TheoreticalCostModel as TCost
from repro_torch.core import get_hardware as t_hw
from repro_torch.core import make_scheduler as t_sched
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import generate_reference as t_reference

from _torch_parity import params_pair, reduced_pair

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_LEN = 64


def requests_spec(vocab, n=5, seed=0, max_i=25, max_o=9):
    """``tests/test_paged_plane.requests_for``'s mixed lengths, as
    (rid, input_len, output_len, arrival, prompt) rows."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        I, O = int(rs.randint(4, max_i)), int(rs.randint(3, max_o))
        out.append((i, I, O, 0.0, rs.randint(0, vocab, size=I).tolist()))
    return out


def shared_prefix_spec(vocab, n=8):
    return [(r.rid, r.input_len, r.output_len, r.arrival, list(r.prompt))
            for r in j_shared_prefix(n=n, input_len=32, prefix_frac=0.75,
                                     output_len=6, vocab=vocab,
                                     stagger=1e-6, seed=3)]


def zipf_spec(vocab):
    return [(r.rid, r.input_len, r.output_len, r.arrival, list(r.prompt))
            for r in j_zipf_shared_prefix(n=24, num_groups=6, page_size=8,
                                          seed=3, vocab=vocab)]


def churn_spec(vocab):
    return requests_spec(vocab, n=8, seed=3, max_i=30, max_o=10)


def partial_spec(vocab):
    return requests_spec(vocab, n=8, seed=2, max_i=28, max_o=16)


CHURN = dict(M_kv=40, nslots=4, page_size=8)
PARTIAL = dict(M_kv=72, nslots=4, page_size=8, sched="sarathi_cs",
               partial_preempt=True)

#: workload -> (spec builder, scheduler/engine settings, expectations:
#: counts that must be at least this; swap-stat keys and the metrics'
#: ``num_partial_preempts``/``num_swaps``)
WORKLOADS = {
    "mixed_page8": (lambda v: requests_spec(v),
                    dict(M_kv=60, nslots=4, page_size=8), {}),
    "shared_prefix_trie": (shared_prefix_spec,
                           dict(M_kv=400, nslots=8, page_size=8, S=512,
                                cache_policy="break_even"),
                           {"trie_hits": 7}),
    # a pool small enough that the break-even policy reclaims prefix pages
    "shared_prefix_reclaim": (lambda v: shared_prefix_spec(v, n=16),
                              dict(M_kv=160, nslots=8, page_size=8, S=512,
                                   cache_policy="break_even"),
                              {"reclaimed": 1}),
    "churn_small_M": (lambda v: requests_spec(v, n=8, seed=3, max_i=30,
                                              max_o=10),
                      dict(M_kv=40, nslots=4, page_size=8),
                      {"preemptions": 1}),
    "mixed_page16": (lambda v: requests_spec(v, n=6, seed=5, max_i=30),
                     dict(M_kv=96, nslots=4, page_size=16,
                          prefix_lookup="exact"), {}),
    # §5.4 swap preemption of whole victims, its Fig. 8 auto choice, and
    # the store-full fallback to recompute
    "churn_swap": (churn_spec, dict(CHURN, preempt_mode="swap"),
                   {"swap_outs": 1, "swap_ins": 1, "kv_out": 1, "kv_in": 1,
                    "num_swaps": 1}),
    "churn_auto": (churn_spec, dict(CHURN, preempt_mode="auto"),
                   {"preemptions": 1}),
    "churn_swap_full": (churn_spec, dict(CHURN, preempt_mode="swap",
                                         swap_bytes=1),
                        {"swap_fallbacks": 1}),
    # §8 page-level partial preemption (tail sheds) under each mode
    "partial_swap": (partial_spec, dict(PARTIAL, preempt_mode="swap"),
                     {"num_partial_preempts": 1, "swap_outs": 1,
                      "swap_ins": 1, "kv_out": 1, "kv_in": 1,
                      "num_swaps": 1}),
    "partial_auto": (partial_spec, dict(PARTIAL, preempt_mode="auto"),
                     {"swap_outs": 1, "num_swaps": 1}),
    "partial_recompute": (partial_spec, dict(PARTIAL),
                          {"num_partial_preempts": 1}),
    # §6 host demotion tier under the break-even policy
    "demotion": (zipf_spec, dict(M_kv=256, nslots=4, page_size=8, S=512,
                                 cache_policy="break_even",
                                 cache_demotion=True),
                 {"demotions": 1, "promotions": 1, "kv_demoted": 1,
                  "kv_promoted": 1, "trie_hits": 1}),
}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = reduced_pair()
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _engine(pkg, models, M_kv, nslots, page_size, S=128, sched="vllm",
            preempt_mode="recompute", partial_preempt=False, **ekw):
    jcfg, tcfg, jp, tp = models
    skw = dict(S=S, replacement="srf", preempt_mode=preempt_mode,
               partial_preempt=partial_preempt)
    if pkg == "jax":
        sched = j_sched(sched, M_kv, **skw)
        return JEngine(jcfg, jp, sched,
                       JEngineConfig(nslots=nslots, cache_len=CACHE_LEN,
                                     chunk=16, plane="paged",
                                     page_size=page_size, **ekw),
                       cost_model=JCost(jcfg, j_hw("tpu_v5e")))
    sched = t_sched(sched, M_kv, **skw)
    return TEngine(tcfg, tp, sched,
                   TEngineConfig(nslots=nslots, cache_len=CACHE_LEN,
                                 chunk=16, plane="paged",
                                 page_size=page_size, **ekw),
                   cost_model=TCost(tcfg, t_hw("tpu_v5e")), device="cpu")


@pytest.fixture(scope="module")
def runs(models):
    """Each workload run once per package (a JAX engine compiles for
    seconds; every test below reads these results), with each engine's
    allocator stats and swap-store state after the run."""
    out = {}
    vocab = models[0].vocab_size
    for name, (spec_fn, kw, _) in WORKLOADS.items():
        spec = spec_fn(vocab)
        res, stats = {}, {}
        for pkg, R in (("jax", JRequest), ("torch", TRequest)):
            reqs = [R(rid=i, input_len=I, output_len=O, arrival=a,
                      prompt=list(p)) for i, I, O, a, p in spec]
            eng = _engine(pkg, models, **kw)
            res[pkg] = eng.run(reqs)
            stats[pkg] = dict(eng.allocator.stats,
                              store_len=len(eng.swap_store),
                              pending=len(eng._pending_swaps)
                              + len(eng._pending_runs)
                              + len(eng._pending_demotes))
        out[name] = (spec, res, stats)
    return out


def _strip(b):
    d = dataclasses.asdict(b)
    d.pop("wall_s")
    return d


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_outputs_identical_to_jax_engine(runs, name):
    _, res, _ = runs[name]
    assert res["torch"].outputs == res["jax"].outputs


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_batch_schedule_identical_to_jax_engine(runs, name):
    _, res, _ = runs[name]
    jb, tb = res["jax"].metrics.batches, res["torch"].metrics.batches
    assert len(tb) == len(jb)
    assert [_strip(b) for b in tb] == [_strip(b) for b in jb]


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_preemption_and_prefix_counts_identical(runs, name):
    _, res, _ = runs[name]
    j, t = res["jax"], res["torch"]
    assert t.metrics.num_preemptions == j.metrics.num_preemptions
    for key in ("trie_hits", "partial_hit_tokens"):
        assert t.swap_stats[key] == j.swap_stats[key], key
    want = WORKLOADS[name][2]
    assert t.metrics.num_preemptions >= want.get("preemptions", 0)
    assert t.swap_stats["trie_hits"] >= want.get("trie_hits", 0)
    assert t.num_compiles == 0
    jst, tst = runs[name][2]["jax"], runs[name][2]["torch"]
    assert tst["reclaimed"] == jst["reclaimed"]
    assert jst["reclaimed"] >= want.get("reclaimed", 0)


def _swap_counts(res):
    """Every ``swap_stats`` key but the measured ``wall_*`` ones, and the
    metrics' preemption, partial-preemption and swap counts."""
    d = {k: v for k, v in res.swap_stats.items()
         if not k.startswith("wall_")}
    m = res.metrics
    d.update(preemptions=m.num_preemptions,
             num_partial_preempts=m.num_partial_preempts,
             num_swaps=m.num_swaps)
    return d


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_swap_stats_identical_to_jax_engine(runs, name):
    """``swap_stats`` key by key (the measured wall keys aside): the port
    keeps the JAX engine's whole key set.  The counts the workload is
    there to exercise are positive, and nothing is left in the store or
    in flight at the end."""
    _, res, stats = runs[name]
    j, t = _swap_counts(res["jax"]), _swap_counts(res["torch"])
    assert set(res["torch"].swap_stats) == set(res["jax"].swap_stats)
    assert t == j
    for key, least in WORKLOADS[name][2].items():
        if key in j:
            assert j[key] >= least, (key, j[key])
    for pkg in ("jax", "torch"):
        assert stats[pkg]["store_len"] == 0 and stats[pkg]["pending"] == 0


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_tokens_equal_both_references(runs, models, name):
    jcfg, tcfg, jp, tp = models
    spec, res, _ = runs[name]
    for rid, _, O, _, prompt in spec:
        want = t_reference(tcfg, tp, prompt, O, cache_len=CACHE_LEN,
                           device="cpu")
        assert res["torch"].outputs[rid] == want, rid
        assert j_reference(jcfg, jp, prompt, O, cache_len=CACHE_LEN) == want


@pytest.mark.parametrize("ekw,skw,item", [
    # the sequence-sharded cache needs a mesh (tests/test_torch_spmd_engine.py
    # serves it on one): without one the engine refuses at construction
    (dict(plane="batched", impl="seqsharded"), {}, "set_mesh"),
    (dict(plane="legacy", impl="seqsharded"), {}, "set_mesh"),
    (dict(plane="batched"), dict(partial_preempt=True),
     "pooled paged data plane"),
    (dict(decode_append="later"), {}, "unknown decode_append"),
])
def test_unported_settings_raise(models, ekw, skw, item):
    _, tcfg, _, tp = models
    sched = t_sched("vllm", 64, S=128, page_size=8, **skw)
    with pytest.raises(ValueError, match=item):
        TEngine(tcfg, tp, sched, TEngineConfig(page_size=8, **ekw),
                device="cpu")


@pytest.mark.parametrize("over,ekw,item", [
    # the MoE family serves; its expert-parallel dispatch needs a mesh
    # (tests/test_torch_spmd_engine.py serves it on one)
    (dict(family="moe", num_experts=4, experts_per_token=2, moe_d_ff=32),
     dict(moe_impl="ep"), "set_mesh"),
    # the hybrid family and sliding windows serve
    # (tests/test_torch_hybrid_engine.py); the VLM and audio families
    # (A10, ported) serve on every plane (tests/test_torch_vlm_engine.py,
    # tests/test_torch_audio_engine.py): accepted here
    (dict(family="vlm"), {}, "A10"),
    (dict(family="audio", frontend="frames"), dict(plane="paged",
                                                   page_size=8), "A10"),
])
def test_non_dense_family_raises(models, over, ekw, item):
    _, tcfg, _, tp = models
    sched = t_sched("vllm", 64, S=128)
    cfg = dataclasses.replace(tcfg, **over)
    if item == "A10":
        eng = TEngine(cfg, tp, sched, TEngineConfig(**ekw), device="cpu")
        assert eng.cfg.family == over["family"]
        return
    with pytest.raises(ValueError, match=item):
        TEngine(cfg, tp, sched, TEngineConfig(**ekw), device="cpu")


def test_warmup_leaves_allocator_pages_untouched(models):
    eng = _engine("torch", models, M_kv=60, nslots=4, page_size=8)
    n = eng.allocator.num_pages
    eng.k_pools[:, :n].normal_()
    before = eng.k_pools[:, :n].clone(), eng.v_pools[:, :n].clone()
    eng.warmup()
    assert torch.equal(eng.k_pools[:, :n], before[0])
    assert torch.equal(eng.v_pools[:, :n], before[1])
    assert (eng.prefill_rounds, eng.decode_steps) == (0, 0)


def test_cow_copy_preserves_owner_pages(models):
    """Forcing a write into a registry-pinned page copies it, leaving the
    registry page (and every sharer) intact."""
    eng = _engine("torch", models, M_kv=400, nslots=8, page_size=8, S=512)
    r = TRequest(rid=0, input_len=16, output_len=2, arrival=0.0,
                 prompt=list(range(100, 116)))
    eng.submit(r)
    eng.step()                 # full prefill: both prompt pages register
    pinned = eng.allocator.table(0).pages[1]
    old = eng.k_pools[:, pinned].clone()
    eng._cow_guard(0, 12)      # mid-page write landing in a pinned page
    assert eng.allocator.stats["cow_copies"] == 1
    new_page = eng.allocator.table(0).pages[1]
    assert new_page != pinned
    assert torch.equal(eng.k_pools[:, new_page], old)
    assert torch.equal(eng.k_pools[:, pinned], old)
    eng.allocator.check_invariants()


def test_step_counters_count_plane_calls(models):
    """``prefill_rounds`` / ``decode_steps`` count the paged plane's
    prefill and decode calls — each runs every layer's kernel once, which
    is what the smoke script holds the kernels' launch counts against."""
    eng = _engine("torch", models, M_kv=60, nslots=4, page_size=8)
    calls = {"prefill": 0, "decode": 0}

    def counted(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    eng._paged_prefill = counted("prefill", eng._paged_prefill)
    eng._paged_decode = counted("decode", eng._paged_decode)
    spec = requests_spec(models[1].vocab_size, n=4, seed=1)
    eng.run([TRequest(rid=i, input_len=I, output_len=O, arrival=a,
                      prompt=p) for i, I, O, a, p in spec])
    assert calls == {"prefill": eng.prefill_rounds,
                     "decode": eng.decode_steps}
    assert eng.prefill_rounds > 0 and eng.decode_steps > 0


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--workload", "shared_prefix"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "trie hits" in proc.stderr


# --------------------------------------------------------------------- #
# RWKV6 on the slot-resident plane
# --------------------------------------------------------------------- #

def rwkv_requests_spec(vocab, n=5, seed=0):
    """``tests/test_engine.py::requests_for``: prompts of 8-24 tokens and
    3-8 output tokens, as (rid, input_len, output_len, arrival, prompt)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        I, O = int(rs.randint(8, 25)), int(rs.randint(3, 9))
        out.append((i, I, O, 0.0, rs.randint(0, vocab, size=I).tolist()))
    return out


#: (plane, page_size[, preempt_mode]): ``paged`` keeps RWKV6's O(1) state
#: slot-resident, as in the JAX engine; page_size 1 is
#: tests/test_engine.py's default; the mode is ``recompute`` unless given
RWKV_RUNS = [("batched", 1), ("paged", 1), ("batched", 8),
             ("batched", 1, "swap"), ("paged", 1, "swap"),
             ("batched", 1, "auto"), ("paged", 1, "auto")]


@pytest.fixture(scope="module")
def rwkv_models():
    jcfg, tcfg = reduced_pair("rwkv6-7b")
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _rwkv_engine(pkg, models, plane, page_size, mode="recompute", M_kv=60):
    """tests/test_engine.py's setting: vLLM + SRF, M=60, 4 slots,
    cache_len 64, chunk 16."""
    jcfg, tcfg, jp, tp = models
    ekw = dict(nslots=4, cache_len=CACHE_LEN, chunk=16, plane=plane,
               page_size=page_size)
    skw = dict(S=128, replacement="srf", preempt_mode=mode)
    if pkg == "jax":
        return JEngine(jcfg, jp, j_sched("vllm", M_kv, **skw),
                       JEngineConfig(**ekw),
                       cost_model=JCost(jcfg, j_hw("tpu_v5e")))
    return TEngine(tcfg, tp, t_sched("vllm", M_kv, **skw),
                   TEngineConfig(**ekw),
                   cost_model=TCost(tcfg, t_hw("tpu_v5e")), device="cpu")


@pytest.fixture(scope="module")
def rwkv_runs(rwkv_models):
    spec = rwkv_requests_spec(rwkv_models[0].vocab_size)
    out = {}
    for run in RWKV_RUNS:
        res = {}
        for pkg, R in (("jax", JRequest), ("torch", TRequest)):
            reqs = [R(rid=i, input_len=I, output_len=O, arrival=a,
                      prompt=list(p)) for i, I, O, a, p in spec]
            eng = _rwkv_engine(pkg, rwkv_models, *run)
            res[pkg] = eng.run(reqs)
            res[pkg + "_engine"] = eng
        out[run] = res
    return spec, out


@pytest.mark.parametrize("run", RWKV_RUNS, ids=str)
def test_rwkv_outputs_identical_to_jax_engine(rwkv_runs, run):
    res = rwkv_runs[1][run]
    assert res["torch"].outputs == res["jax"].outputs


@pytest.mark.parametrize("run", RWKV_RUNS, ids=str)
def test_rwkv_batch_schedule_identical_to_jax_engine(rwkv_runs, run):
    res = rwkv_runs[1][run]
    jb, tb = res["jax"].metrics.batches, res["torch"].metrics.batches
    assert len(tb) == len(jb)
    assert [_strip(b) for b in tb] == [_strip(b) for b in jb]


@pytest.mark.parametrize("run", RWKV_RUNS, ids=str)
def test_rwkv_recompute_preemptions_identical(rwkv_runs, run):
    res = rwkv_runs[1][run]
    assert res["torch"].metrics.num_preemptions == \
        res["jax"].metrics.num_preemptions > 0
    eng = res["torch_engine"]
    assert eng.k_pools is None and set(eng.cache) == {"index", "S", "x_tm",
                                                      "x_cm"}
    assert eng.prefill_rounds > 0 and eng.decode_steps > 0


@pytest.mark.parametrize("run", RWKV_RUNS[3:], ids=str)
def test_rwkv_swap_stats_identical_to_jax_engine(rwkv_runs, run):
    """Swap and ``auto`` on the slot plane (and its ``paged`` fallback):
    the swap counts key by key, every slot snapshot (``index``, ``S``,
    ``x_tm``, ``x_cm``) restored, the store empty at the end."""
    res = rwkv_runs[1][run]
    j, t = _swap_counts(res["jax"]), _swap_counts(res["torch"])
    assert t == j
    if run[2] == "swap":
        assert j["swap_outs"] == j["swap_ins"] > 0 and j["kv_out"] > 0
    for pkg in ("jax", "torch"):
        eng = res[pkg + "_engine"]
        assert len(eng.swap_store) == 0 and not eng._pending_swaps


@pytest.mark.parametrize("run", RWKV_RUNS[:2] + RWKV_RUNS[3:5], ids=str)
def test_rwkv_tokens_equal_both_references(rwkv_models, rwkv_runs, run):
    jcfg, tcfg, jp, tp = rwkv_models
    spec, out = rwkv_runs
    for rid, _, O, _, prompt in spec:
        want = t_reference(tcfg, tp, prompt, O, cache_len=CACHE_LEN,
                           device="cpu")
        assert out[run]["torch"].outputs[rid] == want, rid
        assert j_reference(jcfg, jp, prompt, O, cache_len=CACHE_LEN) == want


def test_rwkv_warmup_and_claims_touch_only_their_slots(rwkv_models):
    """Warmup runs every bucket and the decode step with no live row:
    the slots' state stays bit for bit, the step counters do not move.
    Claiming a slot zeroes that slot's state, and only it."""
    eng = _rwkv_engine("torch", rwkv_models, "batched", 1)
    for leaf in eng.cache.values():
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng.warmup()
    for k in before:
        assert torch.equal(eng.cache[k], before[k]), k
    assert (eng.prefill_rounds, eng.decode_steps) == (0, 0)
    slot = eng._claim_slot(7)
    for k, v in eng.cache.items():
        row = v[slot] if v.dim() == 1 else v[:, slot]
        assert not row.any(), k
        rest = [s for s in range(4) if s != slot]
        kept = (v[rest] if v.dim() == 1 else v[:, rest])
        assert torch.equal(kept, before[k][rest] if v.dim() == 1
                           else before[k][:, rest]), k


def test_rwkv_step_counters_count_chunk_and_decode_calls(rwkv_models):
    """``prefill_rounds`` counts the slot plane's ``prefill_chunk`` calls
    (each runs every layer's WKV6 kernel once: what the smoke script
    holds the kernel's launches against), ``decode_steps`` its decode
    calls."""
    eng = _rwkv_engine("torch", rwkv_models, "batched", 1)
    calls = {"chunk": 0, "decode": 0}

    def counted(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    eng._chunk_fn = counted("chunk", eng._chunk_fn)
    eng._decode_fn = counted("decode", eng._decode_fn)
    spec = rwkv_requests_spec(rwkv_models[1].vocab_size, n=4, seed=1)
    eng.run([TRequest(rid=i, input_len=I, output_len=O, arrival=a,
                      prompt=p) for i, I, O, a, p in spec])
    assert calls == {"chunk": eng.prefill_rounds,
                     "decode": eng.decode_steps}


@pytest.mark.parametrize("ekw,skw,item", [
    (dict(plane="legacy"), dict(partial_preempt=True),
     "pooled paged data plane"),
    ({}, dict(partial_preempt=True), "pooled paged data plane"),
])
def test_rwkv_unported_settings_raise(rwkv_models, ekw, skw, item):
    _, tcfg, _, tp = rwkv_models
    sched = t_sched("vllm", 64, S=128, page_size=8, **skw)
    with pytest.raises(ValueError, match=item):
        TEngine(tcfg, tp, sched, TEngineConfig(page_size=8, **ekw),
                device="cpu")


def test_serve_cli_runs_rwkv_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "rwkv6-7b"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "arch=rwkv6-7b-reduced" in proc.stderr
