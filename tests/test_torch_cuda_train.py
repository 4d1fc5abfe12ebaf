"""The MoE, hybrid and RWKV6 families train on a card: ``train_loss``'s
fp32 gradients on the card equal the port's on the CPU (which
``tests/test_torch_train_families.py`` holds against JAX) for both MoE
dispatches, hymba and RWKV6 (``chip_smoke.family_grads_vs_cpu``); the
hybrid scan's autograd function (``models.ssm.ChunkScan``) gives the
CPU's values and gradients on the card; RWKV6's training never launches
the forward-only WKV6 kernel (B4) while its prefill launches it once a
layer; and a few bf16 steps of ``make_train_step`` on each family leave
the loss finite and falling.  Every test is marked ``cuda`` and skips
where there is none.  This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_train.py
"""
import dataclasses
import importlib.util
import math
import os

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.training import (AdamWConfig, init_adamw, make_loss_fn,
                                  make_train_step, value_and_grad)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's training runs on it, "
                    "and B4 is a CUDA kernel with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("arch,moe_impl", [
    ("qwen2-moe-a2.7b", "sparse"), ("qwen2-moe-a2.7b", "dense"),
    ("qwen3-moe-30b-a3b", "sparse"), ("qwen3-moe-30b-a3b", "dense"),
    ("hymba-1.5b", "sparse"), ("rwkv6-7b", "sparse")])
def test_fp32_grads_on_the_card_match_the_cpu(card, arch, moe_impl):
    out = _chip_smoke().family_grads_vs_cpu(torch, [(arch, moe_impl)])
    (res,) = out.values()
    assert res["worst_of_tol"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 7, 128])
def test_chunk_scan_on_the_card_matches_the_cpu(card, Q):
    g = torch.Generator().manual_seed(Q)
    a = torch.exp(-4.0 * torch.rand((2, Q, 40, 16), generator=g))
    b = torch.randn((2, Q, 40, 16), generator=g)
    w = torch.randn((2, Q, 40, 16), generator=g)

    def run(a, b, w):
        a, b = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        h = ssm.chunk_scan(a, b)
        return (h.detach(),) + torch.autograd.grad(h, (a, b), grad_outputs=w)

    want = run(a, b, w)
    got = run(a.cuda(), b.cuda(), w.cuda())
    for x, y in zip(got, want):
        torch.testing.assert_close(x.cpu(), y, rtol=2e-5, atol=2e-5)
    with torch.no_grad():                 # serving's in-place scan, same bits
        assert torch.equal(got[0], ssm._ssm_core_scan(a.cuda(), b.cuda()))


@pytest.mark.cuda
def test_rwkv_training_never_launches_b4_and_prefill_does(card):
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, 0, device="cuda")
    toks = torch.randint(cfg.vocab_size, (2, 64), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    wkv.wkv6_cuda.launches = 0
    loss, grads = value_and_grad(make_loss_fn(cfg))(
        params, {"tokens": toks, "labels": toks})
    assert wkv.wkv6_cuda.launches == 0 and math.isfinite(float(loss))
    with torch.no_grad():
        M.prefill(cfg, params, {"tokens": toks}, 64)
    assert wkv.wkv6_cuda.launches == cfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch,moe_impl", [
    ("qwen2-moe-a2.7b", "sparse"), ("qwen2-moe-a2.7b", "dense"),
    ("qwen3-moe-30b-a3b", "sparse"), ("hymba-1.5b", "sparse"),
    ("rwkv6-7b", "sparse")])
def test_bf16_steps_lower_the_loss(card, arch, moe_impl):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    params = M.init_params(cfg, 0, device="cuda")
    state = init_adamw(params)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, total_steps=10,
                                            warmup_steps=1),
                           moe_impl=moe_impl)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    losses = []
    for i in range(10):
        batch = {k: torch.from_numpy(v).long().cuda()
                 for k, v in batch_for_step(dcfg, i).items()}
        params, state, m = step(params, state, batch)
        assert math.isfinite(float(m["loss"]))
        assert math.isfinite(float(m["grad_norm"]))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
