"""The engine's step graphs on a card (``repro_torch.serving.step_graphs``):
what the CPU tests cannot show, since on the CPU a graph call is its
function run eagerly.  Each bucket's prefill replay and the decode replay,
on both planes in fp32 and bf16 at reduced size, must equal an eager call
of the same plane function on cloned pools or cache, byte for byte; a
served run under swap and the MIXED fault schedule must give the
reference's tokens through replays alone after a warmup (or with each
shape captured at its first use without one), the kernels' launch
counters still counting layers x steps; and a step that cannot be
captured must raise, naming the step and its shape.  Every test is marked
``cuda`` and skips where there is none.  This file imports neither JAX nor
the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_graphs.py
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (Request, TheoreticalCostModel, get_hardware,
                              make_scheduler)
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig, generate_reference
from repro_torch.serving.faults import FaultSpec
from repro_torch.serving.step_graphs import StepGraphError, StepGraphs

#: ``tests/test_chaos.py``'s MIXED fault schedule, at seed 1
MIXED = dict(seed=1, p_alloc=0.05, p_store_transient=0.3,
             p_store_permanent=0.15, p_corrupt=0.2, p_demote_fail=0.3,
             p_promote_fail=0.3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs are captured and "
                    "replayed only there")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reduced(plane, dtype):
    if plane == "pooled":
        return dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                                   dtype=dtype, head_dim=64)
    return dataclasses.replace(get_config("rwkv6-7b").reduced(), dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plane", ["pooled", "slot"])
def test_replay_equals_eager_call(card, plane, dtype):
    """``chip_smoke.py`` phase 20's comparison at reduced size: from
    random state, every graph's replay (ids, the decode cohort's advance,
    every pool or cache byte) equals the eager plane function on clones."""
    cfg = _reduced(plane, dtype)
    params = M.init_params(cfg, 0, device="cuda")
    eng = Engine(cfg, params, make_scheduler("vllm", 256, S=128),
                 EngineConfig(nslots=4, cache_len=64, chunk=16,
                              page_size=8 if plane == "pooled" else 1,
                              plane="paged" if plane == "pooled"
                              else "batched"),
                 device="cuda").warmup()
    assert eng.num_graphs == len(eng.rungs) * len(eng.buckets) + 1
    assert all(g.graph is not None for g in eng.graphs.graphs.values())
    out = _chip_smoke().replay_vs_eager(torch, eng, seed=7, device="cuda")
    assert eng.graphs.replays == len(eng.rungs) * len(eng.buckets) + 1
    for what, c in out.items():
        assert c["ids_equal"] and c["bit_equal"], (what, c)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False], ids=["warmup", "lazy"])
def test_faulted_swap_serve_replays_every_step(card, warm):
    """A reduced model served under swap, tail sheds and the MIXED fault
    schedule (rollbacks, degraded recomputes).  After ``warmup()`` every
    prefill round and decode step is one replay, no graph is built and no
    step runs eagerly; without it each shape is captured at its first use
    mid-run (that call runs eagerly) and replayed after.  Either way
    B1/B2 count layers x steps and the tokens are the reference's."""
    cfg = _reduced("pooled", "float32")
    params = M.init_params(cfg, 0, device="cuda")
    sched = make_scheduler("sarathi_cs", 72, S=128, replacement="srf",
                           preempt_mode="swap", partial_preempt=True)
    eng = Engine(cfg, params, sched,
                 EngineConfig(nslots=4, cache_len=64, chunk=16, page_size=8,
                              plane="paged", faults=FaultSpec(**MIXED)),
                 cost_model=TheoreticalCostModel(cfg,
                                                 get_hardware("tpu_v5e")),
                 device="cuda")
    if warm:
        eng.warmup()
    rs = np.random.RandomState(2)
    reqs = []
    for i in range(8):
        n, o = int(rs.randint(4, 28)), int(rs.randint(3, 16))
        reqs.append(Request(rid=i, input_len=n, output_len=o, arrival=0.0,
                            prompt=rs.randint(0, cfg.vocab_size,
                                              size=n).tolist()))
    n0, e0 = eng.num_graphs, eng.graphs.eager_calls
    for fn in (pa.paged_decode_cuda, pa.paged_prefill_cuda):
        fn.launches = 0
    res = eng.run(reqs)
    assert res.recovery_stats["rollbacks"] > 0
    assert res.metrics.num_partial_preempts > 0
    built = eng.num_graphs - n0            # captured during the run
    assert eng.num_graphs <= len(eng.rungs) * len(eng.buckets) + 1
    assert built == (0 if warm else eng.num_graphs)
    assert all(g.graph is not None for g in eng.graphs.graphs.values())
    assert eng.graphs.eager_calls == e0 + built
    assert eng.graphs.replays == \
        eng.prefill_rounds + eng.decode_steps - built
    L = cfg.num_layers
    assert pa.paged_prefill_cuda.launches == L * eng.prefill_rounds > 0
    assert pa.paged_decode_cuda.launches == L * eng.decode_steps > 0
    for r in reqs:
        assert res.outputs[r.rid] == generate_reference(
            cfg, params, r.prompt, r.output_len, cache_len=64,
            device="cuda"), r.rid


@pytest.mark.cuda
def test_capture_error_raises(card):
    """A step that synchronises with the host cannot be captured: the
    first call raises ``StepGraphError`` naming the step and its shape,
    and no graph is kept."""
    graphs = StepGraphs(counters=())
    buf = torch.zeros((2, 5), dtype=torch.int32, device="cuda")

    def fn(x):
        x.add_(1)
        return x * int(x.sum().item())      # a host sync inside a capture

    g = graphs.get("decode", lambda: (fn, (buf,), tuple))
    with pytest.raises(StepGraphError, match=r"decode \(2, 5\): capture"):
        g()
    assert g.graph is None
    torch.cuda.synchronize()
