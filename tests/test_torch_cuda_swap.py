"""The swap data plane's host transfers on a card: the races the CPU tests
cannot show.  A snapshot's device-to-host copy runs on the engine's copy
stream while the compute stream goes on; the drained bytes must be those
the pages (or the slot) held when the snapshot was taken, however the
source is overwritten, freed or reused before the drain, and writing them
back must give the same bits.  The step transaction's commit point is
held there too: a rolled-back attempt leaves every live page and slot as
it was while copies are in flight, and a faulted serve gives the
reference's tokens.  Every test is marked ``cuda`` and skips where there
is none.  This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_swap.py
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
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig, generate_reference
from repro_torch.serving.faults import FaultSpec
from repro_torch.serving.host_copy import HostLink, gather_slot, restore_slot

#: ``tests/test_chaos.py``'s MIXED fault schedule, at seed 1
MIXED = dict(seed=1, p_alloc=0.05, p_store_transient=0.3,
             p_store_permanent=0.15, p_corrupt=0.2, p_demote_fail=0.3,
             p_promote_fail=0.3)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the copy stream and its events "
                    "exist only there")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _host(arr, dtype):
    t = torch.from_numpy(arr)
    return t if t.dtype == dtype else t.view(dtype)


def _pool_engine(dtype):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), dtype=dtype)
    return Engine(cfg, None, make_scheduler("vllm", 2048, S=512),
                  EngineConfig(nslots=8, cache_len=512, chunk=128,
                               page_size=16, plane="paged"), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_run_copy_outlives_overwrite_free_and_reuse(gen, dtype):
    eng = _pool_engine(dtype)
    for p in (eng.k_pools, eng.v_pools):
        p.copy_(torch.randn(p.shape, generator=gen, device="cuda").to(
            p.dtype))
    pages = eng.allocator.allocate(0, 304)
    want = {"k": eng.k_pools[:, pages].cpu(), "v": eng.v_pools[:, pages].cpu()}
    kv, xfer = eng._gather_pages_device(pages)
    specs = [(t.shape, t.dtype) for t in kv.values()]
    del kv
    eng.allocator.free(0)
    eng.allocator.allocate(1, 304)            # the pages change hands
    ids = eng._link.ids(pages)
    eng.k_pools.index_fill_(1, ids, 3.0)
    eng.v_pools.index_fill_(1, ids, -3.0)
    junk = [torch.full(s, 5, dtype=d, device="cuda")
            for _ in range(4) for s, d in specs]
    host = eng._link.finish(xfer)
    del junk
    for k in ("k", "v"):
        assert torch.equal(_bits(_host(host[k], eng.k_pools.dtype)),
                           _bits(want[k])), k
    other = eng.allocator.allocate(2, 304)
    eng._restore_pages(other, host)
    torch.cuda.synchronize()
    for k, pool in (("k", eng.k_pools), ("v", eng.v_pools)):
        assert torch.equal(_bits(pool[:, other].cpu()), _bits(want[k])), k
    assert xfer.copy_ms() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_copy_outlives_the_merge(gen, dtype):
    cfg = dataclasses.replace(get_config("rwkv6-7b"), dtype=dtype,
                              num_layers=4)
    eng = Engine(cfg, None, make_scheduler("vllm", 800, S=512),
                 EngineConfig(nslots=4, cache_len=512, chunk=64,
                              page_size=16, plane="batched"), device="cuda")
    for k, leaf in eng.cache.items():
        leaf.copy_(torch.arange(leaf.numel(), device="cuda").view(leaf.shape)
                   * 1000 + 7 if k == "index" else torch.randn(
                       leaf.shape, generator=gen, device="cuda").to(
                           leaf.dtype))
    ax = {k: 0 if v.dim() == 1 else 1 for k, v in eng.cache.items()}
    want = {k: v.select(ax[k], 1).cpu() for k, v in eng.cache.items()}
    xfer = eng._link.start(gather_slot(eng.cache, eng._link.ids([1])))
    active = torch.zeros(4, dtype=torch.bool, device="cuda")
    active[1] = True
    eng._merge(active, {k: torch.full_like(v, 9)
                        for k, v in eng.cache.items()})
    host = eng._link.finish(xfer)
    for k, leaf in eng.cache.items():
        got = _host(host[k], leaf.dtype).select(ax[k], 0)
        assert torch.equal(_bits(got), _bits(want[k])), k
    restore_slot(eng.cache, eng._link.ids([3]),
                 {k: eng._link.to_device(v, eng.cache[k])
                  for k, v in host.items()})
    torch.cuda.synchronize()
    for k, leaf in eng.cache.items():
        assert torch.equal(_bits(leaf.select(ax[k], 3).cpu()),
                           _bits(want[k])), k


@pytest.mark.cuda
def test_dropped_transfer_and_restore_sources_are_safe(gen):
    """A transfer dropped before its drain (a purged run) and a restore
    whose host source is released at once: the copies still finish with
    the right bytes, and the link holds restore sources only until their
    copies have passed."""
    link = HostLink("cuda")
    src = torch.randn((8, 1 << 20), generator=gen, device="cuda")
    dropped = link.start({"x": src.clone()})
    del dropped
    kept = link.start({"x": src.clone()})
    host = link.finish(kept)
    assert torch.equal(torch.from_numpy(host["x"]), src.cpu())
    out = link.to_device(np.array(host["x"]), src)
    assert len(link._held) == 1
    torch.cuda.synchronize()
    link.release()
    assert not link._held and torch.equal(out, src)


@pytest.mark.cuda
@pytest.mark.parametrize("faults", [None, MIXED], ids=["clean", "faulted"])
@pytest.mark.parametrize("async_swap", [True, False])
def test_swap_serve_matches_the_reference_on_card(gen, async_swap, faults):
    """A reduced model served under swap with tail sheds on the card: the
    copies really overlap the compute stream here, and the tokens stay
    the reference's, also under the MIXED fault schedule (rollbacks with
    the copy stream live, degraded recomputes)."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32", head_dim=64)
    params = M.init_params(cfg, 0, device="cuda")
    sched = make_scheduler("sarathi_cs", 72, S=128, replacement="srf",
                           preempt_mode="swap", partial_preempt=True)
    eng = Engine(cfg, params, sched,
                 EngineConfig(nslots=4, cache_len=64, chunk=16, page_size=8,
                              plane="paged", async_swap=async_swap,
                              faults=faults and FaultSpec(**faults)),
                 cost_model=TheoreticalCostModel(cfg,
                                                 get_hardware("tpu_v5e")),
                 device="cuda")
    rs = np.random.RandomState(2)
    reqs = []
    for i in range(8):
        n, o = int(rs.randint(4, 28)), int(rs.randint(3, 16))
        reqs.append(Request(rid=i, input_len=n, output_len=o, arrival=0.0,
                            prompt=rs.randint(0, cfg.vocab_size,
                                              size=n).tolist()))
    res = eng.run(reqs)
    if faults is None:
        assert res.swap_stats["swap_outs"] == res.swap_stats["swap_ins"] > 0
    else:
        assert res.recovery_stats["rollbacks"] > 0
        assert len(eng.swap_store) == 0 and not eng._pending_runs
    assert res.metrics.num_partial_preempts > 0
    for r in reqs:
        assert res.outputs[r.rid] == generate_reference(
            cfg, params, r.prompt, r.output_len, cache_len=64,
            device="cuda"), r.rid


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plane", ["pooled", "slot"])
def test_rollback_leaves_live_state_with_copies_in_flight(gen, plane, dtype):
    """``chip_smoke.py`` phase 17's cases at reduced size: every write kind
    staged into a victim's page or slot while the victims' snapshots are
    on the copy stream, the last allocation faulted; every live page and
    slot bit-equal after the rollback, the retry bit-equal to a
    fault-free step, the in-flight copies drained with their bytes."""
    cs = _chip_smoke()
    arch = "tinyllama-1.1b" if plane == "pooled" else "rwkv6-7b"
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    ecfg = EngineConfig(nslots=4, cache_len=64, chunk=16, page_size=8,
                        plane="paged" if plane == "pooled" else "batched")
    fn = cs.rollback_pooled if plane == "pooled" else cs.rollback_slot
    assert fn(torch, cfg, ecfg, 256, "cuda")["bytes_checked"] > 0
