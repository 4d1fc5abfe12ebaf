"""The port's engine serving the hybrid family (reduced hymba: window 32,
SSM 128 x 4) against the JAX engine on the CPU: identical tokens,
``BatchLog`` schedules (every field but the measured ``wall_s``),
preemption and swap counts, on ``plane="batched"``, the deferred decode,
``plane="legacy"`` and ``plane="paged"`` (which keeps the hybrid
family's bounded state slot-resident, as the JAX engine does), under
recompute, swap and ``auto`` preemption.

Two workloads: ``tests/test_engine.py``'s (prompts of 8-24 tokens, 3-8
outputs; M = 60), and one whose requests wrap the 32-slot ring, four
while prefilling (prompts of 45-100 tokens) and two while decoding
(28 + 10, 31 + 8; M = 110).  The ring-wrapping workload also runs
``impl="paged"`` (B1's dense view: its pages are 64 slots, so the window
is 64 there, and the prompts of 70 and 100 tokens wrap it while
prefilling, 60 + 9 while decoding), held against the JAX engine on the
reference decode.  A faulted swap run (``tests/test_chaos.py``'s MIXED
spec, seed 1) must also match the JAX engine's recovery counts, and a
bf16 slot's snapshot (its fp32 ``h`` leaf beside bf16 K/V) must round
trip through the host bit for bit."""
import dataclasses

import numpy as np
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
from repro_torch.models import model as TM
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import generate_reference as t_reference
from repro_torch.serving.engine import gather_slot, restore_slot
from repro_torch.serving.faults import FaultSpec as TFaultSpec
from repro_torch.serving.host_copy import HostLink

from _torch_parity import params_pair, reduced_pair

torch.set_num_threads(2)

NAME = "hymba-1.5b"
CACHE_LEN = 64
#: (input, output) lengths of the ring-wrapping workload
WRAP = [(45, 6), (28, 10), (70, 5), (31, 8), (100, 4), (60, 9)]
#: workload -> (scheduler M, window)
WORKLOADS = {"short": (60, 32), "wrap": (110, 32), "wrap64": (110, 64)}
#: plane -> (port EngineConfig settings, the JAX engine's or None: same)
PLANES = {"batched": (dict(plane="batched"), None),
          "deferred": (dict(plane="batched", decode_append="deferred"),
                       None),
          "legacy": (dict(plane="legacy"), None),
          "paged": (dict(plane="paged", page_size=8), None),
          "batched_paged": (dict(plane="batched", impl="paged"),
                            dict(plane="batched")),
          "batched_faulted": (dict(plane="batched",
                                   faults=dict(seed=1, **C.MIXED)), None)}
MODES = ("recompute", "swap", "auto")
RUNS = ([("short", p, m) for p in ("batched", "deferred", "legacy", "paged")
         for m in MODES]
        + [("wrap", "batched", m) for m in MODES]
        + [("wrap", "deferred", "recompute"), ("wrap", "legacy", "swap"),
           ("wrap64", "batched_paged", "recompute"),
           ("wrap64", "batched_paged", "swap"),
           ("wrap", "batched_faulted", "swap")])


def _spec(workload, vocab):
    """(rid, input_len, output_len, prompt) rows from a numpy seed."""
    if workload == "short":           # tests/test_engine.py::requests_for
        rs = np.random.RandomState(0)
        out = []
        for i in range(5):
            I, O = int(rs.randint(8, 25)), int(rs.randint(3, 9))
            out.append((i, I, O, rs.randint(0, vocab, size=I).tolist()))
        return out
    rs = np.random.RandomState(1)
    return [(i, I, O, rs.randint(0, vocab, size=I).tolist())
            for i, (I, O) in enumerate(WRAP)]


@pytest.fixture(scope="module")
def models():
    """window -> (jax cfg, torch cfg, jax params, torch params); the
    weights do not depend on the window."""
    jcfg, tcfg = reduced_pair(NAME)
    jp, tp = params_pair(jcfg)
    return {w: (dataclasses.replace(jcfg, window=w),
                dataclasses.replace(tcfg, window=w), jp, tp)
            for w in (32, 64)}


def _engine(pkg, m, ekw, M, mode):
    """``tests/test_engine.py``'s setting: vLLM + SRF, 4 slots,
    ``cache_len`` 64, chunk 16."""
    jcfg, tcfg, jp, tp = m
    ekw = dict(nslots=4, cache_len=CACHE_LEN, chunk=16, **ekw)
    skw = dict(S=128, replacement="srf", preempt_mode=mode)
    faults = ekw.pop("faults", None)
    if faults is not None:
        ekw["faults"] = (JFaultSpec if pkg == "jax" else TFaultSpec)(**faults)
    if pkg == "jax":
        return JEngine(jcfg, jp, j_sched("vllm", M, **skw),
                       JEngineConfig(share_jits=True, **ekw),
                       cost_model=JCost(jcfg, j_hw("tpu_v5e")))
    return TEngine(tcfg, tp, t_sched("vllm", M, **skw), TEngineConfig(**ekw),
                   cost_model=TCost(tcfg, t_hw("tpu_v5e")), device="cpu")


@pytest.fixture(scope="module")
def runs(models):
    out, jax_res = {}, {}
    for workload, plane, mode in RUNS:
        M, window = WORKLOADS[workload]
        m = models[window]
        spec = _spec(workload, m[0].vocab_size)
        tkw, jkw = PLANES[plane]
        jkw = tkw if jkw is None else jkw
        key = (workload, repr(sorted(jkw.items())), mode)
        if key not in jax_res:
            jax_res[key] = _engine("jax", m, jkw, M, mode).run(
                [JRequest(rid=i, input_len=I, output_len=O, arrival=0.0,
                          prompt=list(p)) for i, I, O, p in spec])
        eng = _engine("torch", m, tkw, M, mode).warmup()
        res = eng.run([TRequest(rid=i, input_len=I, output_len=O,
                                arrival=0.0, prompt=list(p))
                       for i, I, O, p in spec])
        out[(workload, plane, mode)] = (spec, jax_res[key], res, eng)
    return out


def _strip(b):
    d = dataclasses.asdict(b)
    d.pop("wall_s")
    return d


def _counts(res):
    d = {k: v for k, v in {**res.swap_stats, **res.recovery_stats}.items()
         if not k.startswith("wall_")}
    d.update(preemptions=res.metrics.num_preemptions,
             num_swaps=res.metrics.num_swaps)
    return d


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_outputs_identical_to_jax_engine(runs, run):
    _, j, t, _ = runs[run]
    assert t.outputs == j.outputs


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_batch_schedule_identical_to_jax_engine(runs, run):
    _, j, t, _ = runs[run]
    assert [_strip(b) for b in t.metrics.batches] == \
        [_strip(b) for b in j.metrics.batches]


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_preemption_and_swap_counts_identical(runs, run):
    """The counts key by key; every run preempts, a swap run swaps every
    snapshot back (each carries the ring, ``h`` and ``conv``), and the
    store is empty at the end."""
    _, j, t, eng = runs[run]
    assert _counts(t) == _counts(j)
    assert t.metrics.num_preemptions > 0
    if run[2] == "swap":
        st = t.swap_stats
        assert st["swap_outs"] == st["swap_ins"] > 0 and st["kv_in"] > 0
    assert len(eng.swap_store) == 0 and not eng._pending_swaps


@pytest.mark.parametrize("run", [r for r in RUNS if r[2] == "recompute"],
                         ids="-".join)
def test_tokens_equal_reference(runs, models, run):
    """Each plane's tokens are ``generate_reference``'s (full prefill,
    then decode with the plane's own ``impl``)."""
    _, tcfg, _, tp = models[WORKLOADS[run[0]][1]]
    spec, _, t, _ = runs[run]
    impl = PLANES[run[1]][0].get("impl", "reference")
    for rid, _, O, prompt in spec:
        assert t.outputs[rid] == t_reference(
            tcfg, tp, prompt, O, cache_len=CACHE_LEN, impl=impl,
            device="cpu"), rid


def test_every_ring_wraps(runs):
    """The ring-wrapping workload wraps the ring while prefilling and
    while decoding, on both windows."""
    for workload in ("wrap", "wrap64"):
        w = WORKLOADS[workload][1]
        spec = _spec(workload, 256)
        assert any(I > w for _, I, _, _ in spec)
        assert any(I <= w < I + O - 1 for _, I, O, _ in spec)


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_step_graph_counts_and_leaves(runs, run):
    """``warmup`` built every graph (the decode graph alone on the legacy
    plane), every graph call was one prefill round or decode step, and
    the slot cache holds the ring (``min(cache_len, window)`` slots)
    beside the fp32 SSM state."""
    _, _, t, eng = runs[run]
    legacy = PLANES[run[1]][0]["plane"] == "legacy"
    n = 1 if legacy else len(eng.buckets) + 1
    assert eng.num_graphs == n and t.num_compiles == 0
    steps = eng.decode_steps + (0 if legacy else eng.prefill_rounds)
    assert eng.graphs.eager_calls == n + steps
    assert eng.k_pools is None and set(eng.cache) == {"index", "k", "v",
                                                      "h", "conv"}
    assert eng.cache["k"].shape[2] == WORKLOADS[run[0]][1]
    assert eng.cache["h"].dtype == torch.float32


def test_chunk_is_clamped_to_the_window_on_a_copy(models):
    """A chunk larger than the window is clamped on the engine's own copy
    of the ``EngineConfig``, as the JAX engine does."""
    m = models[32]
    ecfg = TEngineConfig(nslots=2, cache_len=64, chunk=48)
    eng = TEngine(m[1], m[3], t_sched("vllm", 60, S=128), ecfg,
                  device="cpu")
    assert eng.ecfg.chunk == 32 and ecfg.chunk == 48
    jeng = JEngine(m[0], m[2], j_sched("vllm", 60, S=128),
                   JEngineConfig(nslots=2, cache_len=64, chunk=48))
    assert jeng.ecfg.chunk == eng.ecfg.chunk
    assert eng.buckets[-1] == 32


def test_faulted_swap_run_recovers(runs):
    """The MIXED spec fires on the hybrid slots' swap path (the records
    above equal the JAX engine's, recovery counts included) and changes
    no token."""
    t = runs[("wrap", "batched_faulted", "swap")][2]
    fired = (t.recovery_stats["rollbacks"] + t.swap_stats["transient_retries"]
             + t.swap_stats["permanent_store_failures"])
    assert fired > 0
    assert t.outputs == runs[("wrap", "batched", "recompute")][2].outputs


def test_bf16_slot_round_trip_keeps_the_fp32_state():
    """One bf16 hymba slot (``index``, the bf16 ring, the fp32 ``h``, the
    bf16 ``conv``) gathered, copied to the host, overwritten and restored
    into another slot, bit for bit; the other slots keep their state."""
    _, tcfg = reduced_pair(NAME, dtype="bfloat16")
    cache = TM.init_cache(tcfg, 4, CACHE_LEN, device="cpu")
    assert {k: v.dtype for k, v in cache.items()} == {
        "index": torch.int32, "k": torch.bfloat16, "v": torch.bfloat16,
        "h": torch.float32, "conv": torch.bfloat16}
    g = torch.Generator().manual_seed(2)
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
