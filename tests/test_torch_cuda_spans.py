"""The serving step's spans on a card (``repro_torch.serving.spans``):
under ``torch.profiler`` with CUDA activities, a served run records the
program's ranges on the host and no device interval of its own (a user
range around the same replays gets one), and the kernels its replays run
lie inside ``engine.replay`` spans.  Marked ``cuda``; skips without a
card.  This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_spans.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (Request, TheoreticalCostModel, get_hardware,
                              make_scheduler)
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig, spans

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the device trace exists only "
                    "there")


def test_spans_have_no_device_echo(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="bfloat16", head_dim=64)
    params = M.init_params(cfg, 0, device="cuda")
    cost = TheoreticalCostModel(cfg, get_hardware("h100"))
    eng = Engine(cfg, params,
                 make_scheduler("vllm", 256, S=128, replacement="srf",
                                page_size=16),
                 EngineConfig(nslots=4, cache_len=128, chunk=32,
                              plane="paged", page_size=16),
                 cost_model=cost, device="cuda").warmup()
    g = torch.Generator().manual_seed(1)
    for i, n in enumerate((40, 70, 9)):
        eng.submit(Request(rid=i, input_len=n, output_len=6, arrival=0.0,
                           prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                generator=g).tolist()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("user.serve"):
            while eng.sched.has_work():
                eng.step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    names = {e.name for e in dev}
    assert not {n for n in names if n.startswith(spans.PREFIX)}, names
    assert "user.serve" in names            # a user range is echoed
    replays = [e for e in host if e.name == spans.REPLAY]
    assert len(replays) == eng.prefill_rounds + eng.decode_steps
    assert eng.graphs.replays == len(replays)
    steps = [e for e in host if e.name == spans.STEP]
    assert steps and all(not e.is_user_annotation for e in steps)
    assert eng.phase_stats["replay_s"] > 0
    assert eng.prefill_grid_tokens > eng.prefill_tokens == 40 + 70 + 9
