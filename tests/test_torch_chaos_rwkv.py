"""The port's failure model against the JAX engine's on the slot-resident
plane: RWKV6 ``.reduced()`` on ``plane="batched"`` (the port has no dense
slot plane yet, ROADMAP A5d) in ``tests/test_chaos.py``'s slot setting
(vLLM + SRF, M=60, 4 slots, ``cache_len`` 64, chunk 16, fp32) under
recompute, swap and ``auto`` preemption, each with the ``MIXED`` fault
spec at seeds 0 and 1.  Both engines must give the same outputs,
``BatchLog``s (but ``wall_s``), ``swap_stats`` (but ``wall_*``) and
``recovery_stats`` (but ``wall_aborted_s``), and nothing may be left in
the store.  A straggler run (``straggler_factor=1e-12``: every step is
over the monitor's 1e-4 s floor on both engines) requeues the same number
of times on both."""
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

MODES = C.SLOT_MODES
SEEDS = (0, 1)
#: tests/test_chaos.py::build_slot's engine; page 1 is the JAX default
SLOT = dict(nslots=4, cache_len=64, chunk=16, plane="batched", page_size=1)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = reduced_pair("rwkv6-7b")
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _engine(pkg, models, mode, faults=None, straggler=None):
    jcfg, tcfg, jp, tp = models
    skw = dict(S=128, replacement="srf", preempt_mode=mode)
    ekw = dict(SLOT, straggler_factor=straggler)
    if pkg == "jax":
        return JEngine(jcfg, jp, j_sched("vllm", 60, **skw),
                       JEngineConfig(share_jits=True, **ekw,
                                     faults=faults and JFaultSpec(**faults)),
                       cost_model=JCost(jcfg, j_hw("tpu_v5e")))
    return TEngine(tcfg, tp, t_sched("vllm", 60, **skw),
                   TEngineConfig(**ekw,
                                 faults=faults and TFaultSpec(**faults)),
                   cost_model=TCost(tcfg, t_hw("tpu_v5e")), device="cpu")


def _run(models, mode, **kw):
    rows = [(r.rid, r.input_len, r.output_len, r.arrival, list(r.prompt))
            for r in C.requests_for(models[0])]
    out = {}
    for pkg, R in (("jax", JRequest), ("torch", TRequest)):
        eng = _engine(pkg, models, mode, **kw)
        res = eng.run([R(rid=i, input_len=I, output_len=O, arrival=a,
                         prompt=list(p)) for i, I, O, a, p in rows])
        out[pkg] = (res, len(eng.swap_store) + len(eng._pending_swaps))
    return out


@pytest.fixture(scope="module")
def runs(models):
    out = {(mode, seed): _run(models, mode,
                              faults=dict(seed=seed, **C.MIXED))
           for mode in MODES for seed in SEEDS}
    out["clean"] = _run(models, "recompute")
    out["straggler"] = _run(models, "recompute", straggler=1e-12)
    return out


def _records(res):
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
        counts=(res.metrics.num_preemptions, res.metrics.num_swaps))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_records_identical_to_jax_engine(runs, mode, seed):
    out = runs[(mode, seed)]
    j, t = _records(out["jax"][0]), _records(out["torch"][0])
    for key in j:
        assert t[key] == j[key], key
    assert out["jax"][1] == out["torch"][1] == 0


@pytest.mark.parametrize("mode", MODES)
def test_mixed_faults_fire_on_the_swap_paths(runs, mode):
    """Seeds 0 and 1 together exercise the failure paths wherever the
    mode moves slots to the host store, and tokens stay the fault-free
    run's (``tests/test_chaos.py::test_chaos_slot_plane_smoke``)."""
    clean = runs["clean"]["torch"][0]
    fired = 0
    for seed in SEEDS:
        res = runs[(mode, seed)]["torch"][0]
        assert res.outputs == clean.outputs, seed
        fired += (res.recovery_stats["rollbacks"]
                  + res.swap_stats["transient_retries"]
                  + res.swap_stats["permanent_store_failures"])
    assert mode == "recompute" or fired > 0


def test_straggler_requeues_identical_to_jax_engine(runs):
    out = runs["straggler"]
    j, t = _records(out["jax"][0]), _records(out["torch"][0])
    for key in j:
        assert t[key] == j[key], key
    clean = runs["clean"]["torch"][0]
    assert t["recovery_stats"]["straggler_requeues"] > 0
    assert t["outputs"] == clean.outputs
    assert t["counts"][0] > clean.metrics.num_preemptions
