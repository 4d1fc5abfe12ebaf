"""The engine parity tests of the VLM and audio families (ROADMAP A10),
shared by ``test_torch_vlm_engine.py`` (PaliGemma-3B) and
``test_torch_audio_engine.py`` (MusicGen-medium): each test module sets
``NAME`` and imports the fixtures and tests below.

The port's ``Engine(..., device="cpu")`` on the reduced config in fp32
against the JAX ``Engine`` on the same requests (built from one numpy
spec): identical tokens, ``BatchLog`` schedules (every field but the
measured ``wall_s``) and preemption, prefix-hit and swap counts, on the
pooled plane (page 8) under recompute and swap preemption, on
``batched``, with the deferred append, on ``legacy``, and on ``batched``
with ``impl="paged"`` (B1's dense view; held against the JAX engine's
reference decode), and on a shared-prefix workload with prefix hits.
The requests are text or codec tokens alone, as the JAX engine takes
them; every recompute run's tokens also equal ``generate_reference``."""
import dataclasses

import numpy as np
import pytest

from repro.core import Request as JRequest
from repro.core import TheoreticalCostModel as JCost
from repro.core import get_hardware as j_hw
from repro.core import make_scheduler as j_sched
from repro.data.workloads import shared_prefix as j_shared_prefix
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.core import Request as TRequest
from repro_torch.core import TheoreticalCostModel as TCost
from repro_torch.core import get_hardware as t_hw
from repro_torch.core import make_scheduler as t_sched
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import generate_reference as t_reference

from _torch_parity import params_pair, reduced_pair

CACHE_LEN = 64
#: workload -> scheduler M (tokens): both force preemptions
WORKLOADS = {"short": 60, "shared": 120}
#: plane -> (port EngineConfig settings, the JAX engine's or None: same)
PLANES = {"paged": (dict(plane="paged", page_size=8), None),
          "batched": (dict(plane="batched"), None),
          "deferred": (dict(plane="batched", decode_append="deferred"),
                       None),
          "legacy": (dict(plane="legacy"), None),
          "batched_paged": (dict(plane="batched", impl="paged"),
                            dict(plane="batched"))}
RUNS = ([("short", "paged", m) for m in ("recompute", "swap")]
        + [("short", p, "recompute")
           for p in ("batched", "deferred", "legacy", "batched_paged")]
        + [("shared", "paged", "recompute")])


def _spec(workload, vocab):
    """(rid, input_len, output_len, prompt) rows from a numpy seed."""
    if workload == "short":           # tests/test_engine.py::requests_for
        rs = np.random.RandomState(0)
        out = []
        for i in range(5):
            I, O = int(rs.randint(8, 25)), int(rs.randint(3, 9))
            out.append((i, I, O, rs.randint(0, vocab, size=I).tolist()))
        return out
    return [(r.rid, r.input_len, r.output_len, list(r.prompt))
            for r in j_shared_prefix(n=8, input_len=24, prefix_frac=0.75,
                                     output_len=6, vocab=vocab,
                                     stagger=1e-6, seed=3)]


@pytest.fixture(scope="module")
def models(request):
    jcfg, tcfg = reduced_pair(request.module.NAME)
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _engine(pkg, m, ekw, M, mode):
    """vLLM + SRF, 4 slots, ``cache_len`` 64, chunk 16."""
    jcfg, tcfg, jp, tp = m
    ekw = dict(nslots=4, cache_len=CACHE_LEN, chunk=16, **ekw)
    skw = dict(S=128, replacement="srf", preempt_mode=mode)
    if ekw.get("plane") == "paged":
        skw["page_size"] = ekw["page_size"]
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
        M = WORKLOADS[workload]
        spec = _spec(workload, models[0].vocab_size)
        tkw, jkw = PLANES[plane]
        jkw = tkw if jkw is None else jkw
        key = (workload, repr(sorted(jkw.items())), mode)
        if key not in jax_res:
            jax_res[key] = _engine("jax", models, jkw, M, mode).run(
                [JRequest(rid=i, input_len=I, output_len=O, arrival=0.0,
                          prompt=list(p)) for i, I, O, p in spec])
        eng = _engine("torch", models, tkw, M, mode).warmup()
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
    d = {k: v for k, v in res.swap_stats.items() if not k.startswith("wall_")}
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
def test_preemption_prefix_and_swap_counts_identical(runs, run):
    """The counts key by key; every run preempts, a swap run swaps every
    snapshot back, the shared-prefix run hits the prefix registry."""
    _, j, t, eng = runs[run]
    assert _counts(t) == _counts(j)
    assert t.metrics.num_preemptions > 0
    if run[2] == "swap":
        st = t.swap_stats
        assert st["swap_outs"] == st["swap_ins"] > 0
    if run[0] == "shared":
        assert t.swap_stats["trie_hits"] > 0
    assert len(eng.swap_store) == 0 and not eng._pending_swaps


@pytest.mark.parametrize("run", [r for r in RUNS if r[2] == "recompute"],
                         ids="-".join)
def test_tokens_equal_reference(runs, models, run):
    """Each plane's tokens are ``generate_reference``'s (full prefill,
    then decode with the plane's own ``impl``)."""
    _, tcfg, _, tp = models
    spec, _, t, _ = runs[run]
    impl = PLANES[run[1]][0].get("impl", "reference")
    for rid, _, O, prompt in spec:
        assert t.outputs[rid] == t_reference(
            tcfg, tp, prompt, O, cache_len=CACHE_LEN, impl=impl,
            device="cpu"), rid
