"""The mixture-of-experts family on a card: the dispatches (``models.moe``)
bit-reproducible across repeated calls in both dtypes (the sparse one
also with capacity overflow), a pooled engine's step-graph replays equal
to eager calls of the same functions on cloned random state, byte for
byte, with either dispatch, and reduced qwen2-moe and qwen3-moe at head
dim 128 served on the pooled plane with the reference's tokens and the
paged kernels (B1, B2) launched layers x decode steps and layers x
prefill rounds.  Every test is marked ``cuda`` and skips where there is
none.  This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_moe.py
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
from repro_torch.models import moe
from repro_torch.serving import Engine, EngineConfig, generate_reference

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the paged kernels are CUDA "
                    "kernels with no CPU mode, and step graphs are "
                    "captured only there")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reduced(name, dtype):
    """The reduced config at head dim 128, the paged kernels' width."""
    return dataclasses.replace(get_config(name).reduced(), dtype=dtype,
                               head_dim=128)


def _engine(cfg, params, **ekw):
    sched = make_scheduler("vllm", 60, S=128, replacement="srf")
    return Engine(cfg, params, sched,
                  EngineConfig(nslots=4, cache_len=64, chunk=16, page_size=8,
                               plane="paged", **ekw),
                  cost_model=TheoreticalCostModel(cfg,
                                                  get_hardware("tpu_v5e")),
                  device="cuda").warmup()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_is_bit_reproducible_on_card(card, name, dtype):
    cfg = _reduced(name, dtype)
    lp = M.unstack_layers(M.init_params(cfg, 0, device="cuda"))[0]["moe"]
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    x = torch.randn((2, 8, cfg.d_model), generator=g,
                    device="cuda").to(getattr(torch, dtype))
    _, topi = moe.route(lp, cfg, x.reshape(16, -1))
    _, keep = moe.dispatch_slots(topi, cfg.padded_experts,
                                 moe.capacity(cfg, 16, 1.0))
    assert not bool(keep.all()), "capacity 1.0 must overflow here"
    for fn, kw in ((moe.apply_moe, {}),
                   (moe.apply_moe_sparse, {}),
                   (moe.apply_moe_sparse, dict(capacity_factor=1.0))):
        first = fn(lp, cfg, x, **kw)
        assert bool(torch.isfinite(first.float()).all())
        for _ in range(3):
            assert torch.equal(fn(lp, cfg, x, **kw), first), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("moe_impl", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_replay_equals_eager_call(card, dtype, moe_impl):
    """``chip_smoke.py`` phase 20's comparison on the pooled plane: each
    (row rung, bucket) prefill replay and the decode replay (ids, the
    advanced cohort and every pool byte) equal the eager functions on
    clones."""
    cfg = _reduced("qwen2-moe-a2.7b", dtype)
    params = M.init_params(cfg, 0, device="cuda")
    eng = _engine(cfg, params, moe_impl=moe_impl)
    assert eng.num_graphs == len(eng.rungs) * len(eng.buckets) + 1
    out = _chip_smoke().replay_vs_eager(torch, eng, seed=13, device="cuda")
    for what, c in out.items():
        assert c["ids_equal"] and c["bit_equal"], (what, c)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_moe_served_on_card_matches_the_reference(card, name):
    """Reduced MoE in fp32 at head dim 128 on the pooled plane, with
    recompute preemptions: the reference's tokens, and B1 and B2
    launched once per layer of every decode step and prefill round."""
    cfg = _reduced(name, "float32")
    params = M.init_params(cfg, 0, device="cuda")
    eng = _engine(cfg, params)
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(5):
        n, o = int(rs.randint(8, 25)), int(rs.randint(3, 9))
        reqs.append(Request(rid=i, input_len=n, output_len=o, arrival=0.0,
                            prompt=rs.randint(0, cfg.vocab_size,
                                              size=n).tolist()))
    pa.paged_decode_cuda.launches = pa.paged_prefill_cuda.launches = 0
    res = eng.run(reqs)
    assert res.metrics.num_preemptions > 0
    assert pa.paged_decode_cuda.launches == cfg.num_layers * eng.decode_steps
    assert pa.paged_prefill_cuda.launches == \
        cfg.num_layers * eng.prefill_rounds
    for r in reqs:
        assert res.outputs[r.rid] == generate_reference(
            cfg, params, r.prompt, r.output_len, cache_len=64,
            device="cuda"), r.rid
