"""The hybrid family's kernels and serve on a card: B1 through the dense
view of hymba's ring (25 q over 5 kv heads, G = 5, over a full 2048-slot
ring and at its page edges) and B3 with hymba's 2048-token window over
S > 2048, each against its plain version in both dtypes; a reduced
hymba at head dim 64 with a 64-slot window served on the slot plane with
``impl="paged"``: the reference's tokens (``generate_reference(impl=
"flash")``: B3 with the window on its prefill), B1 launched once per
layer of every decode step, and every step-graph replay bit-equal to the
eager call on cloned state.  Every test is marked ``cuda`` and skips
where there is none.  This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_hybrid.py
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
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention import ref
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig, generate_reference

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: B1 and B3 are CUDA kernels with "
                    "no CPU mode, and step graphs are captured only there")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ctx", [[1, 63, 64, 65], [2047, 2048, 2048, 1],
                                 [2048] * 4])
def test_b1_on_hymbas_full_ring(card, dtype, ctx):
    """q (4, 25, 64) over a (4, 2048, 5, 64) ring viewed as 64-slot pages:
    within tolerance of the plain version and of plain attention over
    the first ctx slots (attention is order-free, so a wrapped ring needs
    no reordering)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    B, H, Hkv, D, S = 4, 25, 5, 64, 2048
    q = _randn(gen, B, H, D, dtype=dtype)
    k, v = (_randn(gen, B, S, Hkv, D, dtype=dtype) for _ in range(2))
    cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    n0 = pa.paged_decode_cuda.launches
    got = pa_ops.decode_attention_dense(q, k, v, cl)
    assert pa.paged_decode_cuda.launches == n0 + 1
    bt = torch.arange(B * S // 64, dtype=torch.int32,
                      device="cuda").view(B, -1)
    want = ref.paged_decode_reference(q, k.view(-1, 64, Hkv, D),
                                      v.view(-1, 64, Hkv, D), bt, cl)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [2048, 2049, 3100])
def test_b3_with_hymbas_window(card, dtype, S):
    """B3 causal with window 2048 at hymba's heads, S at and past the
    window: within tolerance of the plain version."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S)
    q = _randn(gen, 1, S, 25, 64, dtype=dtype)
    k, v = (_randn(gen, 1, S, 5, 64, dtype=dtype) for _ in range(2))
    got = fa.flash_attention_cuda(q, k, v, window=2048)
    want = fref.attention_reference(q, k, v, window=2048)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _reduced(dtype):
    """Reduced hymba at head dim 64 (B1/B3's width) with a 64-slot
    window (B1's dense view takes whole 64-slot pages)."""
    return dataclasses.replace(get_config("hymba-1.5b").reduced(),
                               dtype=dtype, head_dim=64, window=64)


def _engine(cfg, params):
    sched = make_scheduler("vllm", 110, S=128, replacement="srf")
    return Engine(cfg, params, sched,
                  EngineConfig(nslots=4, cache_len=64, chunk=16,
                               impl="paged"),
                  cost_model=TheoreticalCostModel(cfg,
                                                  get_hardware("tpu_v5e")),
                  device="cuda").warmup()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_replay_equals_eager_call(card, dtype):
    cfg = _reduced(dtype)
    eng = _engine(cfg, M.init_params(cfg, 0, device="cuda"))
    out = _chip_smoke().replay_vs_eager(torch, eng, seed=13, device="cuda")
    for what, c in out.items():
        assert c["ids_equal"] and c["bit_equal"], (what, c)


@pytest.mark.cuda
def test_hybrid_served_on_card_matches_the_reference(card):
    """fp32, prompts that wrap the 64-slot ring while prefilling and while
    decoding, recompute preemptions: ``generate_reference(impl="flash")``'s
    tokens, and B1 launched once per layer of every decode step."""
    cfg = _reduced("float32")
    params = M.init_params(cfg, 0, device="cuda")
    eng = _engine(cfg, params)
    rs = np.random.RandomState(1)
    reqs = [Request(rid=i, input_len=n, output_len=o, arrival=0.0,
                    prompt=rs.randint(0, cfg.vocab_size, size=n).tolist())
            for i, (n, o) in enumerate([(45, 6), (28, 10), (70, 5), (31, 8),
                                        (100, 4), (60, 9)])]
    pa.paged_decode_cuda.launches = 0
    res = eng.run(reqs)
    assert res.metrics.num_preemptions > 0
    assert pa.paged_decode_cuda.launches == cfg.num_layers * eng.decode_steps
    for r in reqs:
        assert res.outputs[r.rid] == generate_reference(
            cfg, params, r.prompt, r.output_len, cache_len=64, impl="flash",
            device="cuda"), r.rid
