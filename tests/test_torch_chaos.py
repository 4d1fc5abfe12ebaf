"""The port's failure model against the JAX engine's on the pooled paged
plane: the four ``PAGED_CONFIGS`` of ``tests/test_chaos.py`` (full-suspend
swap churn, tail shedding, the host demotion tier, the radix trie) with
their workloads, each under no fault, allocation faults alone
(``p_alloc=0.5``), the ``MIXED`` spec at seed 1 and the ``FAULTED`` spec.
Both engines must give the same outputs, the same ``BatchLog``s (every
field but the measured ``wall_s``), the same ``swap_stats`` (but the
``wall_*`` keys) and the same ``recovery_stats`` (but
``wall_aborted_s``); faulted outputs must equal the fault-free run's, and
the faulted specs must really fire.  A straggler run requeues at every
step on both engines.  Requests are built from one spec into each
package's own ``Request``."""
import dataclasses

import pytest
import torch

import test_chaos as C
from repro.core import Request as JRequest
from repro.core import TheoreticalCostModel as JCost
from repro.core import get_hardware as j_hw
from repro.core import make_scheduler as j_sched
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.faults import FaultSpec as JFaultSpec
from repro_torch.core import Request as TRequest
from repro_torch.core import TheoreticalCostModel as TCost
from repro_torch.core import get_hardware as t_hw
from repro_torch.core import make_scheduler as t_sched
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving.faults import FaultSpec as TFaultSpec

from _torch_parity import params_pair, reduced_pair

torch.set_num_threads(2)

#: fault schedule -> FaultSpec fields (``tests/test_chaos.py``'s)
SPECS = {
    "faultless": dict(seed=0),
    "alloc": dict(seed=5, p_alloc=0.5),
    "mixed": dict(seed=1, **C.MIXED),
    "faulted": dataclasses.asdict(C.FAULTED),
}
CONFIGS = sorted(C.PAGED_CONFIGS)
#: the straggler run: full-suspend swap churn, every step requeued
STRAGGLER = "swap"


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = reduced_pair()
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _spec_rows(jcfg, name):
    return [(r.rid, r.input_len, r.output_len, r.arrival, list(r.prompt))
            for r in C.paged_workload(jcfg, name)]


def _engine(pkg, models, name, faults=None, straggler=None):
    """``tests/test_chaos.py::build_paged`` in either package (page 8, 4
    slots, ``cache_len`` 64, chunk 16, fp32, the tpu_v5e cost model)."""
    jcfg, tcfg, jp, tp = models
    kw = C.PAGED_CONFIGS[name]
    skw = dict(S=kw["S"], replacement="srf",
               preempt_mode=kw["preempt_mode"],
               partial_preempt=kw.get("partial", False))
    ekw = dict(nslots=4, cache_len=64, chunk=16, plane="paged", page_size=8,
               cache_policy=kw.get("policy", "lru"),
               cache_demotion=kw.get("demotion", False),
               straggler_factor=straggler)
    if pkg == "jax":
        return JEngine(jcfg, jp, j_sched(kw["scheduler"], kw["M_kv"], **skw),
                       JEngineConfig(share_jits=True, **ekw,
                                     faults=faults and JFaultSpec(**faults)),
                       cost_model=JCost(jcfg, j_hw("tpu_v5e")))
    return TEngine(tcfg, tp, t_sched(kw["scheduler"], kw["M_kv"], **skw),
                   TEngineConfig(**ekw,
                                 faults=faults and TFaultSpec(**faults)),
                   cost_model=TCost(tcfg, t_hw("tpu_v5e")), device="cpu")


def _run(models, name, **kw):
    rows = _spec_rows(models[0], name)
    out = {}
    for pkg, R in (("jax", JRequest), ("torch", TRequest)):
        eng = _engine(pkg, models, name, **kw)
        res = eng.run([R(rid=i, input_len=I, output_len=O, arrival=a,
                         prompt=list(p)) for i, I, O, a, p in rows])
        out[pkg] = (res, dict(store=len(eng.swap_store),
                              pending=len(eng._pending_swaps)
                              + len(eng._pending_runs)
                              + len(eng._pending_demotes)))
    return out


@pytest.fixture(scope="module")
def runs(models):
    """Every (config, fault schedule) pair run once per package, and the
    straggler run."""
    out = {(name, spec): _run(models, name, faults=SPECS[spec])
           for name in CONFIGS for spec in SPECS}
    out["straggler"] = _run(models, STRAGGLER, straggler=1e-12)
    return out


def _records(res):
    """Outputs, BatchLogs, swap_stats and recovery_stats, measured wall
    values aside."""
    logs = []
    for b in res.metrics.batches:
        d = dataclasses.asdict(b)
        d.pop("wall_s")
        logs.append(d)
    return dict(
        outputs=res.outputs, batches=logs,
        swap_stats={k: v for k, v in res.swap_stats.items()
                    if not k.startswith("wall_")},
        recovery_stats={k: v for k, v in res.recovery_stats.items()
                        if k != "wall_aborted_s"},
        counts=(res.metrics.num_preemptions,
                res.metrics.num_partial_preempts, res.metrics.num_swaps))


def _fired(res) -> int:
    rec, st = res.recovery_stats, res.swap_stats
    return (rec["rollbacks"] + rec["integrity_failures"]
            + st["transient_retries"] + st["permanent_store_failures"]
            + st["demote_drops"] + st["prefix_integrity"])


CASES = [(name, spec) for name in CONFIGS for spec in SPECS]


@pytest.mark.parametrize("name,spec", CASES, ids=lambda v: str(v))
def test_records_identical_to_jax_engine(runs, name, spec):
    out = runs[(name, spec)]
    j, t = _records(out["jax"][0]), _records(out["torch"][0])
    assert set(out["torch"][0].recovery_stats) == \
        set(out["jax"][0].recovery_stats)
    for key in j:
        assert t[key] == j[key], key
    for pkg in ("jax", "torch"):
        assert out[pkg][1] == dict(store=0, pending=0), pkg


@pytest.mark.parametrize("name,spec", CASES, ids=lambda v: str(v))
def test_faulted_outputs_equal_the_fault_free_run(runs, name, spec):
    res = runs[(name, spec)]["torch"][0]
    clean = runs[(name, "faultless")]["torch"][0]
    assert res.outputs == clean.outputs
    if spec == "faultless":
        assert _fired(res) == 0 and res.recovery_stats["alloc_faults"] == 0
    elif spec == "alloc":
        rec = res.recovery_stats
        assert rec["alloc_faults"] > 0
        assert rec["rollbacks"] == rec["alloc_faults"]
    elif spec == "faulted" and not (clean.swap_stats["swap_outs"]
                                    + clean.swap_stats["swap_fallbacks"]
                                    + clean.swap_stats["demotions"]):
        # FAULTED draws no allocation fault, and this workload (the
        # trie's) puts nothing in the store: no fault site, nothing fires
        assert _fired(res) == 0
    else:
        assert _fired(res) > 0


def test_straggler_requeues_identical_to_jax_engine(runs):
    out = runs["straggler"]
    j, t = _records(out["jax"][0]), _records(out["torch"][0])
    for key in j:
        assert t[key] == j[key], key
    assert t["recovery_stats"]["straggler_requeues"] > 0
    clean = runs[(STRAGGLER, "faultless")]["torch"][0]
    assert t["outputs"] == clean.outputs
    assert t["counts"][0] > clean.metrics.num_preemptions
