"""The port's ``Engine`` over a device mesh (``serving.spmd``) against
the JAX one-device engine, on 2 ``gloo`` CPU ranks of a (1, 2) ``("data",
"model")`` mesh.

One spawn (``launch.mesh.run_ranks``) serves every case inside the ranks
(``tests/_torch_spmd_workers.py``, which import the port only), while
this process runs the JAX engine on the same workloads under a
one-device mesh (``repro.distributed.context.set_mesh``) with the same
``impl`` / ``moe_impl``.  Each case holds both ranks' tokens,
``BatchLog`` schedules (every field but the measured ``wall_s``), swap
and recovery counts equal to each other and to JAX's:

* (a) reduced TinyLlama, ``impl="seqsharded"`` on the ``batched`` plane,
  ``decode_append`` inline and deferred, recompute and swap preemption,
  on a shared-prefix workload whose M forces preemptions;
* (b) the same on the ``legacy`` plane, recompute;
* (c) reduced qwen2-moe, ``moe_impl="ep"`` on the ``paged`` plane,
  recompute;
* (d) the straggler: (a)'s inline recompute engine with
  ``straggler_factor``, rank 1 sleeping inside one decode step.  Both
  ranks requeue at that step (the wall is agreed before the monitor
  reads it), and the JAX engine, given the same requeue at the same step,
  schedules the same.

Beside the cases, ``apply_moe_ep`` on decode-shaped tokens at a capacity
where rows overflow: both ranks take the same results.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest

import _torch_spmd_workers as W
from repro.core import Request as JRequest
from repro.core import TheoreticalCostModel as JCost
from repro.core import get_hardware as j_hw
from repro.core import make_scheduler as j_sched
from repro.data.workloads import shared_prefix as j_shared_prefix
from repro.distributed.context import set_mesh as j_set_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.launch.mesh import run_ranks

from _torch_parity import params_pair, reduced_pair

#: the spawn's own limit: the cases take ~15 s on 2 idle CPU ranks
SPAWN_TIMEOUT_S = 240.0
MESH = (1, 2)
#: (d): a decode step's priced dt is ~2.4e-7 s (reduced TinyLlama on the
#: tpu_v5e cost model), so its deadline is ~2.4 s: far above an eager
#: step's wall here, below the sleep
STRAGGLER_FACTOR = 1e7
SLOW_STEP = 3
SLEEP_S = 3.0

ENGINE = dict(nslots=4, cache_len=64, chunk=16, page_size=8)
BASE = dict(M=48, S=128)


def _case(preempt_mode="recompute", **ekw):
    return dict(BASE, preempt_mode=preempt_mode, engine=dict(ENGINE, **ekw))


#: name -> (arch, settings)
CASES = {
    **{f"seqsharded_batched_{app}_{mode}": (
        "tinyllama-1.1b", _case(mode, plane="batched", impl="seqsharded",
                                decode_append=app))
       for app in ("inline", "deferred") for mode in ("recompute", "swap")},
    "seqsharded_legacy_recompute": (
        "tinyllama-1.1b", _case(plane="legacy", impl="seqsharded")),
    "ep_paged_recompute": ("qwen2-moe-a2.7b",
                           _case(plane="paged", moe_impl="ep")),
    "straggler": ("tinyllama-1.1b", dict(
        _case(plane="batched", impl="seqsharded",
              straggler_factor=STRAGGLER_FACTOR),
        slow_rank=1, slow_step=SLOW_STEP, sleep_s=SLEEP_S)),
}


def _spec(vocab):
    return [(r.rid, r.input_len, r.output_len, r.arrival, list(r.prompt))
            for r in j_shared_prefix(n=6, input_len=24, prefix_frac=0.75,
                                     output_len=6, vocab=vocab,
                                     stagger=1e-6, seed=3)]


def _jax_run(jcfg, jp, spec, case):
    """JAX's engine on one device, under a one-device mesh of the same
    axes; in the straggler case its monitor is also told of the step at
    which the ranks' agreed wall overran."""
    sched = j_sched(case.get("sched", "vllm"), case["M"], S=case["S"],
                    replacement="srf",
                    preempt_mode=case.get("preempt_mode", "recompute"))
    eng = JEngine(jcfg, jp, sched, JEngineConfig(**case["engine"]),
                  cost_model=JCost(jcfg, j_hw("tpu_v5e"))).warmup()
    if "slow_step" in case:
        observe = eng._straggler.observe

        def forced(predicted_s, actual_s):
            flagged = observe(predicted_s=predicted_s, actual_s=actual_s)
            return flagged or eng._step_no == case["slow_step"]
        eng._straggler.observe = forced
    res = eng.run([JRequest(rid=i, input_len=n_in, output_len=n_out,
                            arrival=a, prompt=list(p))
                   for i, n_in, n_out, a, p in spec])
    logs = []
    for b in res.metrics.batches:
        d = dataclasses.asdict(b)
        d.pop("wall_s")
        logs.append(d)
    m = res.metrics
    return {
        "outputs": {int(k): list(v) for k, v in res.outputs.items()},
        "logs": logs,
        "swap": {k: v for k, v in res.swap_stats.items()
                 if not k.startswith("wall_")},
        "recovery": {k: v for k, v in res.recovery_stats.items()
                     if k != "wall_aborted_s"},
        "metrics": dict(preemptions=m.num_preemptions,
                        partial=m.num_partial_preempts, swaps=m.num_swaps),
    }


@pytest.fixture(scope="module")
def served():
    """The ranks' results and JAX's, per case: the spawn runs in a thread
    while this process runs the JAX engines."""
    models, cases = {}, {}
    for name, (arch, case) in CASES.items():
        if arch not in models:
            jcfg, _ = reduced_pair(arch)
            jp, _ = params_pair(jcfg)
            models[arch] = (jcfg, jp, jax.tree.map(np.asarray, jp),
                            _spec(jcfg.vocab_size))
        jcfg, jp, np_params, spec = models[arch]
        cases[name] = (arch, np_params, spec, case)
    box = {}

    def spawn():
        try:
            box["ranks"] = run_ranks(W.serve_cases, 2, MESH, cases,
                                     device="cpu",
                                     timeout_s=SPAWN_TIMEOUT_S)
        except BaseException as e:   # re-raised in the test's thread
            box["error"] = e

    t = threading.Thread(target=spawn)
    t.start()
    jax_mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
    j_set_mesh(jax_mesh)
    try:
        refs = {name: _jax_run(models[arch][0], models[arch][1],
                               models[arch][3], case)
                for name, (arch, case) in CASES.items()}
    finally:
        j_set_mesh(None)
        t.join(SPAWN_TIMEOUT_S + 60)     # run_ranks kills its ranks first
    assert not t.is_alive(), "the ranks' spawn did not return"
    if "error" in box:
        raise box["error"]
    return box["ranks"], refs


KEYS = ("outputs", "logs", "swap", "recovery", "metrics")


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree(served, name):
    ranks, _ = served
    r0, r1 = ranks[0][name], ranks[1][name]
    for key in KEYS + ("requeue_steps",):
        assert r0[key] == r1[key], key


@pytest.mark.parametrize("name", list(CASES))
def test_equal_to_jax_one_device_engine(served, name):
    ranks, refs = served
    got, want = ranks[0][name], refs[name]
    for key in KEYS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("name", list(CASES))
def test_steps_run_eagerly_on_placed_tensors(served, name):
    """No step graph over a mesh; the sharded leaves are DTensors."""
    ranks, _ = served
    r = ranks[0][name]
    assert r["num_graphs"] == 0 and r["eager_calls"] > 0
    arch, case = CASES[name]
    if case["engine"].get("impl") == "seqsharded":
        assert r["cache_types"] == ["DTensor", "Tensor"]
    if case["engine"].get("moe_impl") == "ep":
        assert r["cache_types"] == [] and "DTensor" in r["expert_types"]


@pytest.mark.parametrize("name", [n for n in CASES if n != "straggler"])
def test_workloads_preempt(served, name):
    """Every case preempts at least once, and the swap cases swap."""
    ranks, _ = served
    r = ranks[0][name]
    assert r["metrics"]["preemptions"] >= 1
    if name.endswith("_swap"):
        assert r["swap"]["swap_outs"] >= 1 and r["swap"]["swap_ins"] >= 1


def test_straggler_requeues_on_the_same_step(served):
    ranks, refs = served
    r0, r1 = ranks[0]["straggler"], ranks[1]["straggler"]
    assert r0["requeue_steps"] == r1["requeue_steps"] == [SLOW_STEP]
    assert r0["recovery"]["straggler_requeues"] == 1
    assert refs["straggler"]["recovery"]["straggler_requeues"] == 1
    # the requeue changed the schedule, not the tokens
    assert r0["outputs"] == ranks[0]["seqsharded_batched_inline_recompute"][
        "outputs"]
    assert r0["logs"] != ranks[0]["seqsharded_batched_inline_recompute"][
        "logs"]


def test_no_mesh_refusal_names_set_mesh(served):
    ranks, _ = served
    assert "set_mesh" in ranks[0]["no_mesh"]


def test_ep_ranks_agree_where_replicated_tokens_overflow(served):
    """Decode-shaped tokens are replicated over the expert axis, so every
    rank sends the same rows and a later rank's copy overflows first;
    every rank takes the first rank's results (``apply_moe_ep``)."""
    ranks, _ = served
    (y0, dense), (y1, _) = ranks[0]["moe_replicated"], \
        ranks[1]["moe_replicated"]
    assert np.array_equal(y0, y1)
    assert not np.allclose(y0, dense, rtol=1e-4, atol=1e-4)   # it dropped
