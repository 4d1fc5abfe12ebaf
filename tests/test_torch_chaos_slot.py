"""The port's failure model against the JAX engine's on the dense
slot-resident plane: TinyLlama ``.reduced()`` in ``tests/test_chaos.py``'s
``build_slot`` setting (vLLM + SRF, M=60, 4 slots, ``cache_len`` 64, chunk
16, page 1, fp32, ``plane="batched"``, the JAX default) under recompute,
swap and ``auto`` preemption, each with the ``MIXED`` fault spec at seeds
0 and 1; and the deferred-append decode and the legacy plane under swap
with the same spec.  Both engines must give the same outputs, ``BatchLog``s
(but ``wall_s``), ``swap_stats`` (but ``wall_*``) and ``recovery_stats``
(but ``wall_aborted_s``), and nothing may be left in the store.  A
straggler run (``straggler_factor=1e-12``) requeues the same number of
times on both.  Tolerance: none, every record is compared for equality."""
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
SLOT = dict(nslots=4, cache_len=64, chunk=16, page_size=1)
PLANES = {"batched": dict(plane="batched"),
          "deferred": dict(plane="batched", decode_append="deferred"),
          "legacy": dict(plane="legacy")}
#: (plane, mode, seed) of the faulted runs
FAULTED = [("batched", m, s) for m in MODES for s in SEEDS] \
    + [("deferred", "swap", 1), ("legacy", "swap", 1)]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = reduced_pair()
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _engine(pkg, models, plane, mode, faults=None, straggler=None):
    jcfg, tcfg, jp, tp = models
    skw = dict(S=128, replacement="srf", preempt_mode=mode)
    ekw = dict(SLOT, **PLANES[plane], straggler_factor=straggler)
    if pkg == "jax":
        return JEngine(jcfg, jp, j_sched("vllm", 60, **skw),
                       JEngineConfig(share_jits=True, **ekw,
                                     faults=faults and JFaultSpec(**faults)),
                       cost_model=JCost(jcfg, j_hw("tpu_v5e")))
    return TEngine(tcfg, tp, t_sched("vllm", 60, **skw),
                   TEngineConfig(**ekw,
                                 faults=faults and TFaultSpec(**faults)),
                   cost_model=TCost(tcfg, t_hw("tpu_v5e")),
                   device="cpu").warmup()


def _run(models, plane, mode, **kw):
    rows = [(r.rid, r.input_len, r.output_len, r.arrival, list(r.prompt))
            for r in C.requests_for(models[0])]
    out = {}
    for pkg, R in (("jax", JRequest), ("torch", TRequest)):
        eng = _engine(pkg, models, plane, mode, **kw)
        res = eng.run([R(rid=i, input_len=I, output_len=O, arrival=a,
                         prompt=list(p)) for i, I, O, a, p in rows])
        out[pkg] = (res, len(eng.swap_store) + len(eng._pending_swaps))
    return out


@pytest.fixture(scope="module")
def runs(models):
    out = {run: _run(models, *run[:2], faults=dict(seed=run[2], **C.MIXED))
           for run in FAULTED}
    out["clean"] = _run(models, "batched", "recompute")
    out["straggler"] = _run(models, "batched", "recompute", straggler=1e-12)
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


@pytest.mark.parametrize("run", FAULTED, ids=lambda r: "-".join(map(str, r)))
def test_records_identical_to_jax_engine(runs, run):
    out = runs[run]
    j, t = _records(out["jax"][0]), _records(out["torch"][0])
    for key in j:
        assert t[key] == j[key], key
    assert out["jax"][1] == out["torch"][1] == 0


@pytest.mark.parametrize("run", FAULTED, ids=lambda r: "-".join(map(str, r)))
def test_faulted_tokens_equal_the_fault_free_run(runs, run):
    """Faults never change tokens (``tests/test_chaos.py::test_chaos_
    slot_plane_smoke``), on every plane."""
    clean = runs["clean"]["torch"][0]
    assert runs[run]["torch"][0].outputs == clean.outputs


@pytest.mark.parametrize("mode", MODES)
def test_mixed_faults_fire_on_the_swap_paths(runs, mode):
    """Seeds 0 and 1 together exercise the failure paths wherever the
    mode moves slots to the host store."""
    fired = 0
    for seed in SEEDS:
        res = runs[("batched", mode, seed)]["torch"][0]
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
