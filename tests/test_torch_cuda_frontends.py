"""The VLM and audio families' kernels and serves on a card: B1, B2 and
B3 at head dim 256 with PaliGemma-3B's 8 query heads over 1 (B1 across
its split edges, B2 with padded and length-0 rows and the pool bytes
outside the written slots kept, B3 with the bidirectional image prefix),
each one launch of its dtype's variant against its plain version in
both dtypes; a reduced PaliGemma at head dim 256 served on the pooled
plane (tokens equal to ``generate_reference``, B1/B2 launched once per
layer of every decode step / prefill round, replays bit-equal to eager
calls) and prefilled with patch embeddings on B3 (logits against
``impl="reference"``); a reduced MusicGen at head dim 64 served on the
pooled plane.  Every test is marked ``cuda`` and skips where there is
none.  This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_frontends.py
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
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention import ref
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig, generate_reference

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
H, HKV, D = 8, 1, 256
VARIANT = {torch.float32: "mma_3xtf32", torch.bfloat16: "wgmma"}
DECODE_VARIANT = {torch.float32: "split_simt", torch.bfloat16: "split_mma"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: B1-B3 are CUDA kernels with no "
                    "CPU mode, and step graphs are captured only there")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _one_launch(fn, before, variant):
    after = fn.launches_by_variant
    assert after == {k: n + (k == variant) for k, n in before.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_at_head_dim_256(card, dtype):
    """Contexts 1, one before, on and past the 64-key split edges, and the
    table's full width (512), over shuffled pages of 16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    ctx = [1, 63, 64, 65, 127, 128, 129, 300, 511, 512]
    B, page, npages = len(ctx), 16, 32
    P = B * npages + 3
    q = _randn(gen, B, H, D, dtype=dtype)
    kp, vp = (_randn(gen, P, page, HKV, D, dtype=dtype) for _ in range(2))
    bt = torch.randperm(P, generator=gen, device="cuda")[:B * npages] \
        .view(B, npages).to(torch.int32)
    cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    before = dict(pa.paged_decode_cuda.launches_by_variant)
    got = pa.paged_decode_cuda(q, kp, vp, bt, cl)
    _one_launch(pa.paged_decode_cuda, before, DECODE_VARIANT[dtype])
    want = ref.paged_decode_reference(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [8, 64])
def test_b2_at_head_dim_256(card, dtype, page):
    """Starts off the 64-key tile, a padded row and a length-0 row: the
    outputs of real rows against the plain version, padded rows zero,
    the pools equal to the plain version's and every byte outside the
    written slots as it was."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(page)
    B, c = 4, 96
    starts, lengths = [0, 37, 100, 129], [96, 50, 0, 80]
    maxp = -(-(129 + c) // page)
    P = B * maxp + 3
    q = _randn(gen, B, c, H, D, dtype=dtype)
    k, v = (_randn(gen, B, c, HKV, D, dtype=dtype) for _ in range(2))
    kp, vp = (_randn(gen, P, page, HKV, D, dtype=dtype) for _ in range(2))
    bt = torch.randperm(P, generator=gen, device="cuda")[:B * maxp] \
        .view(B, maxp).to(torch.int32)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kp0, vp0 = kp.clone(), vp.clone()
    kp2, vp2 = kp.clone(), vp.clone()
    before = dict(pa.paged_prefill_cuda.launches_by_variant)
    got = pa.paged_prefill_cuda(q, k, v, kp, vp, bt, st, ln)
    _one_launch(pa.paged_prefill_cuda, before, VARIANT[dtype])
    want = ref.paged_prefill_reference(q, k, v, kp2, vp2, bt, st, ln)
    torch.cuda.synchronize()
    valid = torch.arange(c, device="cuda")[None] < ln[:, None]
    torch.testing.assert_close(got[valid].float(), want[valid].float(),
                               **TOL[dtype])
    assert not got[~valid].float().abs().any()
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    pos = st[:, None].long() + torch.arange(c, device="cuda")[None]
    dest = torch.gather(bt.long(), 1, torch.clamp(pos // page, 0, maxp - 1)) \
        * page + pos % page
    written = torch.zeros(P * page, dtype=torch.bool, device="cuda")
    written[dest[valid]] = True
    keep = ~written.view(P, page)
    assert torch.equal(kp[keep], kp0[keep]) and torch.equal(vp[keep],
                                                            vp0[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,prefix_len", [(77, 0), (197, 100), (512, 256)])
def test_b3_at_head_dim_256_with_the_image_prefix(card, dtype, S, prefix_len):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S)
    q = _randn(gen, 2, S, H, D, dtype=dtype)
    k, v = (_randn(gen, 2, S, HKV, D, dtype=dtype) for _ in range(2))
    before = dict(fa.flash_attention_cuda.launches_by_variant)
    got = fa.flash_attention_cuda(q, k, v, prefix_len=prefix_len)
    _one_launch(fa.flash_attention_cuda, before, VARIANT[dtype])
    want = fref.attention_reference(q, k, v, prefix_len=prefix_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _reduced(name, dtype):
    """The reduced config at the widest head the config's family serves
    at full width: PaliGemma's 256, MusicGen's 64."""
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, dtype=dtype,
                               head_dim=256 if cfg.family == "vlm" else 64)


def _engine(cfg, params):
    sched = make_scheduler("vllm", 60, S=128, replacement="srf",
                           page_size=8)
    return Engine(cfg, params, sched,
                  EngineConfig(nslots=4, cache_len=64, chunk=16,
                               page_size=8, plane="paged"),
                  cost_model=TheoreticalCostModel(cfg,
                                                  get_hardware("tpu_v5e")),
                  device="cuda").warmup()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paligemma-3b", "musicgen-medium"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_replay_equals_eager_call(card, name, dtype):
    cfg = _reduced(name, dtype)
    eng = _engine(cfg, M.init_params(cfg, 0, device="cuda"))
    out = _chip_smoke().replay_vs_eager(torch, eng, seed=13, device="cuda")
    for what, c in out.items():
        assert c["ids_equal"] and c["bit_equal"], (what, c)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paligemma-3b", "musicgen-medium"])
def test_frontend_served_on_card_matches_the_reference(card, name):
    """fp32 on the pooled plane with recompute preemptions:
    ``generate_reference``'s tokens, B1 and B2 launched once per layer of
    every decode step and prefill round."""
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


@pytest.mark.cuda
def test_vlm_prefill_with_patches_on_b3(card):
    """Reduced PaliGemma at head dim 256 in fp32: ``prefill(impl=
    "flash")`` with 4 patch embeddings in front of 20 text tokens, one B3
    launch per layer, logits and cache against ``impl="reference"``."""
    cfg = _reduced("paligemma-3b", "float32")
    params = M.init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 20),
                                     generator=gen, device="cuda"),
             "patch_embeds": torch.randn((2, cfg.num_patches, cfg.d_model),
                                         generator=gen, device="cuda")}
    n0 = fa.flash_attention_cuda.launches
    fl, fc = M.prefill(cfg, params, batch, cache_len=32, impl="flash")
    assert fa.flash_attention_cuda.launches == n0 + cfg.num_layers
    rf, rc = M.prefill(cfg, params, batch, cache_len=32)
    torch.cuda.synchronize()
    torch.testing.assert_close(fl, rf, rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        torch.testing.assert_close(fc[k], rc[k], rtol=2e-5, atol=2e-5)
    assert fc["index"].tolist() == [20 + cfg.num_patches] * 2
