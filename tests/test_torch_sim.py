"""The port's control plane beyond the engine, against the JAX package on
the CPU: ``EngineConfig`` (the same fields and defaults, and the same
schedules with ``EngineConfig()`` in both packages and with
``prefix_sharing=False`` on the pooled plane), the simulation loop
(``simulate``, ``run_sim``, the ``PrefixTierSim`` shadow and the fault
mirror), the §7 optimal schedule (``core.csp``) and the §5.3 SLO Pareto
curve (``core.slo``); and the port's engine against the port's own
simulator with a ``PrefixTierSim`` shadow, as ``tests/test_chaos.py``
holds the JAX engine against the JAX simulator."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.data import workloads as jwl
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.faults import FaultSpec as JFaultSpec
from repro_torch import core as tcore
from repro_torch.data import workloads as twl
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving.faults import FaultSpec as TFaultSpec

from _torch_parity import params_pair, reduced_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = reduced_pair()
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _strip(b):
    d = dataclasses.asdict(b)
    d.pop("wall_s")
    return d


def _logs(res):
    return [_strip(b) for b in res.batches]


# --------------------------------------------------------------------- #
# EngineConfig (ROADMAP C2)
# --------------------------------------------------------------------- #

def test_engine_config_fields_and_defaults_are_jax_s():
    """Every field of the JAX ``EngineConfig`` with its default, in its
    order, save ``share_jits`` (a step graph belongs to one engine)."""
    jf = [(f.name, f.default) for f in dataclasses.fields(JEngineConfig)
          if f.name != "share_jits"]
    tf = [(f.name, f.default) for f in dataclasses.fields(TEngineConfig)]
    assert tf == jf
    assert TEngineConfig().plane == "batched"
    assert TEngineConfig().page_size == 1


def _c2_spec(vocab, n=8, seed=0):
    """ROADMAP C2's input: prompts of 8-24 tokens and 3-8 outputs."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        I, O = int(rs.randint(8, 25)), int(rs.randint(3, 9))
        out.append((i, I, O, 0.0, rs.randint(0, vocab, size=I).tolist()))
    return out


def _shared_spec(vocab):
    return [(r.rid, r.input_len, r.output_len, r.arrival, list(r.prompt))
            for r in jwl.shared_prefix(n=8, input_len=32, prefix_frac=0.75,
                                       output_len=6, vocab=vocab,
                                       stagger=1e-6, seed=3)]


#: run -> (spec builder, scheduler M, EngineConfig settings)
C2_RUNS = {
    "default": (_c2_spec, 60, {}),
    "paged_no_sharing": (_shared_spec, 400,
                         dict(plane="paged", page_size=8, nslots=8,
                              cache_len=64, chunk=16,
                              prefix_sharing=False)),
    "paged_sharing": (_shared_spec, 400,
                      dict(plane="paged", page_size=8, nslots=8,
                           cache_len=64, chunk=16)),
}


@pytest.fixture(scope="module")
def c2_runs(models):
    jcfg, tcfg, jp, tp = models
    out = {}
    for name, (spec_fn, M_kv, ekw) in C2_RUNS.items():
        spec = spec_fn(jcfg.vocab_size)
        res, eng = {}, {}
        for pkg in ("jax", "torch"):
            R = jcore.Request if pkg == "jax" else tcore.Request
            reqs = [R(rid=i, input_len=I, output_len=O, arrival=a,
                      prompt=list(p)) for i, I, O, a, p in spec]
            if pkg == "jax":
                e = JEngine(jcfg, jp, jcore.make_scheduler(
                    "vllm", M_kv, S=128, replacement="srf"),
                    JEngineConfig(**ekw),
                    cost_model=jcore.TheoreticalCostModel(
                        jcfg, jcore.get_hardware("tpu_v5e")))
            else:
                e = TEngine(tcfg, tp, tcore.make_scheduler(
                    "vllm", M_kv, S=128, replacement="srf"),
                    TEngineConfig(**ekw),
                    cost_model=tcore.TheoreticalCostModel(
                        tcfg, tcore.get_hardware("tpu_v5e")), device="cpu")
            res[pkg], eng[pkg] = e.run(reqs), e
        out[name] = (res, eng)
    return out


@pytest.mark.parametrize("name", list(C2_RUNS))
def test_engine_config_schedules_equal_jax(c2_runs, name):
    res, eng = c2_runs[name]
    j, t = res["jax"], res["torch"]
    assert t.outputs == j.outputs
    assert _logs(t.metrics) == _logs(j.metrics)
    assert t.metrics.num_preemptions == j.metrics.num_preemptions
    assert t.swap_stats["trie_hits"] == j.swap_stats["trie_hits"]
    assert eng["torch"].buckets == eng["jax"].buckets
    if name == "default":
        assert eng["torch"].k_pools is None      # the slot plane
        assert t.metrics.num_preemptions > 0
    elif name == "paged_no_sharing":
        # no attach, no registration: nothing in the registry to hit
        assert t.swap_stats["trie_hits"] == 0
        assert eng["torch"].allocator.stats["prefix_hits"] == 0
        assert len(eng["torch"].allocator.prefix_cache) == 0
    else:
        assert t.swap_stats["trie_hits"] > 0


def test_check_invariants_off_skips_the_step_checks(models, monkeypatch):
    """``check_invariants=False``: the allocator's and the store's checks
    never run, and the tokens are unchanged."""
    _, tcfg, _, tp = models
    spec = _c2_spec(tcfg.vocab_size, n=4)

    def run(check):
        eng = TEngine(tcfg, tp, tcore.make_scheduler("vllm", 60, S=128,
                                                     replacement="srf"),
                      TEngineConfig(check_invariants=check), device="cpu")
        calls = []
        monkeypatch.setattr(eng.allocator, "check_invariants",
                            lambda: calls.append(1))
        res = eng.run([tcore.Request(rid=i, input_len=I, output_len=O,
                                     arrival=a, prompt=list(p))
                       for i, I, O, a, p in spec])
        return res.outputs, len(calls)

    (on, n_on), (off, n_off) = run(True), run(False)
    assert on == off and n_on > 0 and n_off == 0


# --------------------------------------------------------------------- #
# the simulation loop
# --------------------------------------------------------------------- #

def _cost(pkg, name="llama2-7b", hw="a100"):
    c = jcore if pkg == "jax" else tcore
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    cfg = (jget if pkg == "jax" else tget)(name)
    return c.TheoreticalCostModel(cfg, c.get_hardware(hw), flops_eff=0.6,
                                  bw_eff=0.75, attn_bw_eff=0.25)


def _workload(pkg, name):
    wl = jwl if pkg == "jax" else twl
    if name == "hetero":
        return wl.hetero_mix(["SISO", "SILO", "LISO"], 24, seed=1)
    if name == "azureconv":
        return wl.azureconv_like(32, seed=2)
    return wl.fixed_grid(16, 96, 24)


#: (scheduler, replacement, preempt_mode, workload, M)
SIM_RUNS = [("vllm", "srf", "recompute", "hetero", 2048),
            ("vllm", "nrf", "swap", "hetero", 2048),
            ("sarathi", "srf", "auto", "hetero", 2048),
            ("sarathi_cs", "lrf", "recompute", "fixed", 2048),
            ("orca", None, "recompute", "fixed", 65536),
            ("vllm_pf", None, "recompute", "azureconv", 16384)]


@pytest.mark.parametrize("sched,repl,mode,wl,M", SIM_RUNS)
def test_run_sim_equals_jax(sched, repl, mode, wl, M):
    out = {}
    for pkg in ("jax", "torch"):
        c = jcore if pkg == "jax" else tcore
        out[pkg] = c.run_sim(sched, _workload(pkg, wl), _cost(pkg), M=M,
                             S=16384, replacement=repl, preempt_mode=mode)
    j, t = out["jax"], out["torch"]
    assert t.summary() == j.summary()
    assert _logs(t) == _logs(j)
    assert (t.num_preemptions, t.num_partial_preempts, t.num_swaps) == \
        (j.num_preemptions, j.num_partial_preempts, j.num_swaps)
    assert [(r.rid, r.finish_time, r.first_token_time)
            for r in t.requests] == \
        [(r.rid, r.finish_time, r.first_token_time) for r in j.requests]
    if mode == "swap":
        assert t.num_swaps > 0


def test_fresh_requests_equal_jax():
    spec = [(8, 4, 0.0), (16, 2, 0.5), (32, 8, 1.0)]
    j, t = jcore.fresh_requests(spec), tcore.fresh_requests(spec)
    assert [(r.rid, r.input_len, r.output_len, r.arrival) for r in t] == \
        [(r.rid, r.input_len, r.output_len, r.arrival) for r in j]


#: the paged engine configurations of tests/test_chaos.py
PAGED_CONFIGS = {
    "swap": dict(scheduler="vllm", M_kv=60, S=128, preempt_mode="swap"),
    "partial": dict(scheduler="sarathi_cs", M_kv=72, S=128,
                    preempt_mode="swap", partial=True),
    "demotion": dict(scheduler="vllm", M_kv=256, S=512,
                     preempt_mode="recompute", demotion=True,
                     policy="break_even"),
    "trie": dict(scheduler="vllm", M_kv=256, S=512,
                 preempt_mode="recompute", demotion=True,
                 policy="break_even"),
}
FAULTED = dict(seed=4, p_store_transient=0.5, p_store_permanent=0.2,
               p_corrupt=0.3, p_demote_fail=0.3, p_promote_fail=0.3)


def _paged_workload(pkg, vocab, name):
    """``tests/test_chaos.paged_workload`` from either package."""
    wl = jwl if pkg == "jax" else twl
    R = jcore.Request if pkg == "jax" else tcore.Request
    if name == "demotion":
        return wl.zipf_shared_prefix(n=16, num_groups=6, page_size=8,
                                     seed=1, vocab=vocab)
    if name == "trie":
        return wl.conversation_tree(n=12, page_size=8, vocab=vocab)
    rs = np.random.RandomState(2 if name == "partial" else 0)
    lo, hi, olo, ohi, n = ((4, 28, 3, 16, 8) if name == "partial"
                           else (8, 25, 3, 9, 5))
    out = []
    for i in range(n):
        I, O = int(rs.randint(lo, hi)), int(rs.randint(olo, ohi))
        out.append(R(rid=i, input_len=I, output_len=O, arrival=0.0,
                     prompt=rs.randint(0, vocab, size=I).tolist()))
    return out


def _page_nbytes(cfg, page_size):
    return 2 * cfg.num_layers * page_size * cfg.num_kv_heads \
        * cfg.head_dim_ * 4


def _shadow_sim(pkg, cfg, name, faults):
    """``simulate`` with a ``PrefixTierSim`` shadow over the paged
    configuration ``name`` (4 slots, page 8), in package ``pkg``."""
    c = jcore if pkg == "jax" else tcore
    kw = PAGED_CONFIGS[name]
    cm = c.TheoreticalCostModel(cfg, c.get_hardware("tpu_v5e"))
    sched = c.make_scheduler(kw["scheduler"], kw["M_kv"], S=kw["S"],
                             replacement="srf",
                             preempt_mode=kw["preempt_mode"], page_size=8,
                             partial_preempt=kw.get("partial", False),
                             cache_policy=kw.get("policy", "lru"),
                             cache_demotion=kw.get("demotion", False))
    sched.cfg.max_running = 4
    sched.cfg.faults = faults
    shadow = c.PrefixTierSim(sched.cfg, cm,
                             page_nbytes=_page_nbytes(cfg, 8))
    return c.simulate(sched, _paged_workload(pkg, cfg.vocab_size, name),
                      cm, prefix_sim=shadow)


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["faultless", "faulted"])
@pytest.mark.parametrize("name", sorted(PAGED_CONFIGS))
def test_simulate_with_prefix_shadow_equals_jax(models, name, faulted):
    jcfg, tcfg = models[:2]
    spec = FAULTED if faulted else dict(seed=0)
    j = _shadow_sim("jax", jcfg, name, JFaultSpec(**spec))
    t = _shadow_sim("torch", tcfg, name, TFaultSpec(**spec))
    assert _logs(t) == _logs(j)
    assert t.prefix_stats == j.prefix_stats
    assert t.recovery_stats == j.recovery_stats
    assert (t.num_preemptions, t.num_swaps) == (j.num_preemptions,
                                                j.num_swaps)


# --------------------------------------------------------------------- #
# the port's engine against the port's simulator (tests/test_chaos.py)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("faulted", [False, True],
                         ids=["faultless", "faulted"])
@pytest.mark.parametrize("name", sorted(PAGED_CONFIGS))
def test_engine_matches_own_simulator(models, name, faulted):
    """The port's pooled engine and the port's ``simulate`` with a
    ``PrefixTierSim`` shadow draw one fault schedule and agree on the
    abort/degrade trace, the prefix tier's counts and the preemptions."""
    _, tcfg, _, tp = models
    kw = PAGED_CONFIGS[name]
    spec = TFaultSpec(**(FAULTED if faulted else dict(seed=0)))
    sched = tcore.make_scheduler(kw["scheduler"], kw["M_kv"], S=kw["S"],
                                 replacement="srf",
                                 preempt_mode=kw["preempt_mode"],
                                 partial_preempt=kw.get("partial", False))
    eng = TEngine(tcfg, tp, sched,
                  TEngineConfig(nslots=4, cache_len=64, chunk=16,
                                plane="paged", page_size=8,
                                cache_policy=kw.get("policy", "lru"),
                                cache_demotion=kw.get("demotion", False),
                                faults=spec),
                  cost_model=tcore.TheoreticalCostModel(
                      tcfg, tcore.get_hardware("tpu_v5e")), device="cpu")
    res = eng.run(_paged_workload("torch", tcfg.vocab_size, name))
    sim = _shadow_sim("torch", tcfg, name, spec)
    assert sim.recovery_stats["rollbacks"] == \
        eng.recovery_stats["rollbacks"] - eng.recovery_stats["alloc_faults"]
    for key in ("integrity_failures", "degraded_recomputes"):
        assert sim.recovery_stats[key] == eng.recovery_stats[key], key
    for key in ("permanent_store_failures", "transient_retries",
                "swap_fallbacks"):
        assert sim.recovery_stats[key] == eng.swap_stats[key], key
    assert sim.recovery_stats["backoff_s"] == \
        pytest.approx(eng.swap_stats["backoff_s"])
    for key in ("demote_drops", "prefix_integrity", "demotions",
                "promotions"):
        assert sim.prefix_stats[key] == eng.swap_stats[key], key
    assert sim.num_preemptions == res.metrics.num_preemptions
    assert sim.num_swaps == res.metrics.num_swaps


# --------------------------------------------------------------------- #
# §7 CSP and §5.3 SLO
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("reqs,M,C", [
    ([(4, 2)], 16, 4096), ([(4, 4)] * 4, 12, 4096),
    ([(4, 3), (6, 2)], 12, 8), ([(16, 4)] * 3, 32, 4096)])
def test_solve_optimal_schedule_equals_jax(reqs, M, C):
    from repro.core.csp import schedule_uses_preemption as j_uses
    from repro_torch.core.csp import schedule_uses_preemption as t_uses
    j = jcore.solve_optimal_schedule(reqs, M=M, C=C, cost_model=_cost("jax"))
    t = tcore.solve_optimal_schedule(reqs, M=M, C=C,
                                     cost_model=_cost("torch"))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t_uses(t) == j_uses(j)
    assert tcore.exists_schedule_below(
        reqs, M=M, C=C, cost_model=_cost("torch"),
        bound=j.optimal_time * 1.01) == jcore.exists_schedule_below(
        reqs, M=M, C=C, cost_model=_cost("jax"), bound=j.optimal_time * 1.01)


@pytest.mark.parametrize("threshold", [0.05, 1.0])
def test_pareto_curve_equals_jax(threshold):
    from repro.core import slo as jslo
    from repro_torch.core import slo as tslo
    kw = dict(num_prefill=8, num_decode=32, threshold=threshold,
              cs=(1, 64, 1024, 4096))
    j = jcore.pareto_curve(_cost("jax"), **kw)
    t = tcore.pareto_curve(_cost("torch"), **kw)
    assert [dataclasses.asdict(p) for p in t] == \
        [dataclasses.asdict(p) for p in j]
    assert tslo.balanced_intensity(128, 32, 8, 2) == \
        jslo.balanced_intensity(128, 32, 8, 2)
