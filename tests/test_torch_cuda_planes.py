"""The dense slot-resident planes and the legacy plane on a card: B1
through ``decode_attention_dense`` (the contiguous cache viewed as
64-token pages) against its plain version, fp32 to 2e-5 and bf16 to 2e-2;
a dense slot plane's bucket and decode replays against eager calls of the
same functions on cloned random state, byte for byte; and reduced
TinyLlama served on ``batched`` (``impl="paged"``), ``batched`` with the
deferred append and ``legacy``, with the reference's tokens, B1 launched
layers x decode steps only where ``impl="paged"``, and the legacy plane's
decode replayed while its prefill runs eagerly.  Then the pooled
plane's packed prefill graphs, one per (row rung, bucket), captured from
the largest grid down, each replay against its eager call.  Every test
is marked ``cuda`` and skips where there is none.  This file imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_planes.py
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
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention import ref
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig, generate_reference

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
VARIANT = {torch.float32: "split_simt", torch.bfloat16: "split_mma"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: B1 is a CUDA kernel with no CPU "
                    "mode, and step graphs are captured only there")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_decode_attention_dense_matches_plain(card, dtype, S):
    """One launch of the dtype's variant per call, against the plain
    paged decode on the same identity-table view; contexts of 1, a page
    edge, one past it and the whole cache."""
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    B, H, Hkv, D = 4, 32, 4, 64
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    ctx = torch.tensor([1, 64, min(65, S), S], dtype=torch.int32,
                       device="cuda")
    before = dict(pa.paged_decode_cuda.launches_by_variant)
    got = pa_ops.decode_attention_dense(q, k, v, ctx)
    after = pa.paged_decode_cuda.launches_by_variant
    assert after == {n: c + (n == VARIANT[dtype]) for n, c in
                     before.items()}
    n = S // 64
    bt = torch.arange(B * n, dtype=torch.int32, device="cuda").view(B, n)
    want = ref.paged_decode_reference(q, k.view(B * n, 64, Hkv, D),
                                      v.view(B * n, 64, Hkv, D), bt, ctx)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _reduced(dtype):
    return dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype=dtype, head_dim=64)


def _engine(cfg, params, **ekw):
    sched = make_scheduler("vllm", 60, S=128, replacement="srf")
    return Engine(cfg, params, sched,
                  EngineConfig(nslots=4, cache_len=64, chunk=16, page_size=1,
                               **ekw),
                  cost_model=TheoreticalCostModel(cfg,
                                                  get_hardware("tpu_v5e")),
                  device="cuda").warmup()


@pytest.mark.cuda
@pytest.mark.parametrize("ekw", [dict(impl="paged"),
                                 dict(decode_append="deferred")],
                         ids=["paged", "deferred"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_replay_equals_eager_call(card, dtype, ekw):
    """``chip_smoke.py`` phase 20's comparison on the dense slot plane:
    from random state, each bucket's prefill replay and the decode replay
    (ids and every cache byte) equal the eager functions on clones."""
    cfg = _reduced(dtype)
    params = M.init_params(cfg, 0, device="cuda")
    eng = _engine(cfg, params, plane="batched", **ekw)
    assert eng.num_graphs == len(eng.buckets) + 1
    out = _chip_smoke().replay_vs_eager(torch, eng, seed=11, device="cuda")
    for what, c in out.items():
        assert c["ids_equal"] and c["bit_equal"], (what, c)


@pytest.mark.cuda
@pytest.mark.parametrize("ekw", [dict(plane="batched", impl="paged"),
                                 dict(plane="batched",
                                      decode_append="deferred"),
                                 dict(plane="legacy")],
                         ids=["paged", "deferred", "legacy"])
def test_served_planes_replay_and_match_the_reference(card, ekw):
    """A reduced model served with recompute preemptions: the reference's
    tokens; B1 launched layers x decode steps with ``impl="paged"`` and
    never otherwise; every step a replay (the legacy plane: the decode
    graph alone, once per decode step, its prefill eager)."""
    cfg = _reduced("float32")
    params = M.init_params(cfg, 0, device="cuda")
    eng = _engine(cfg, params, **ekw)
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(5):
        n, o = int(rs.randint(8, 25)), int(rs.randint(3, 9))
        reqs.append(Request(rid=i, input_len=n, output_len=o, arrival=0.0,
                            prompt=rs.randint(0, cfg.vocab_size,
                                              size=n).tolist()))
    pa.paged_decode_cuda.launches = 0
    n0, e0, r0 = eng.num_graphs, eng.graphs.eager_calls, eng.graphs.replays
    res = eng.run(reqs)
    assert res.metrics.num_preemptions > 0
    legacy = ekw["plane"] == "legacy"
    assert eng.num_graphs == n0 == (1 if legacy else len(eng.buckets) + 1)
    assert eng.graphs.eager_calls == e0
    assert eng.graphs.replays - r0 == eng.decode_steps + (
        0 if legacy else eng.prefill_rounds)
    paged = ekw.get("impl") == "paged"
    assert pa.paged_decode_cuda.launches == (
        cfg.num_layers * eng.decode_steps if paged else 0)
    for r in reqs:
        assert res.outputs[r.rid] == generate_reference(
            cfg, params, r.prompt, r.output_len, cache_len=64,
            device="cuda"), r.rid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_prefill_replays_equal_eager_calls(card, dtype):
    """The pooled plane's prefill graphs, one per (row rung, bucket):
    ``warmup`` captures them from the largest grid to the smallest, then
    the decode graph; each replay of a packed grid (distinct random slots,
    some rows of length 0) gives the ids and every pool byte of the eager
    call on clones with those slots' block tables
    (``chip_smoke.replay_vs_eager``)."""
    cfg = _reduced(dtype)
    params = M.init_params(cfg, 0, device="cuda")
    eng = Engine(cfg, params, make_scheduler("vllm", 512, S=256),
                 EngineConfig(nslots=8, cache_len=64, chunk=16, page_size=8,
                              plane="paged"),
                 device="cuda").warmup()
    assert eng.rungs == [1, 8]
    keys = list(eng.graphs.graphs)
    assert len(keys) == len(eng.rungs) * len(eng.buckets) + 1
    assert keys[-1] == "decode"
    sizes = [r * (w - 3) for r, w in
             (eng.graphs.graphs[k].inputs[0].shape for k in keys[:-1])]
    assert sizes == sorted(sizes, reverse=True)
    assert all(g.graph is not None for g in eng.graphs.graphs.values())
    out = _chip_smoke().replay_vs_eager(torch, eng, seed=17, device="cuda")
    assert sorted(out) == sorted(keys)
    for what, c in out.items():
        assert c["ids_equal"] and c["bit_equal"], (what, c)
