"""The dropless grouped MoE dispatch (``models.moe.apply_moe_grouped``,
``kernels/moe_grouped``'s plain version on the CPU) against the dense
dispatch and the benchmark's float32 reference, at a small shape built
here (16 experts of width 32, top 4, no shared expert, qk-norm on: the
shape of Qwen3-MoE cut down), and the paged plane and engine serving with
it.  Float32 throughout but for the bit-equality cases.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe_grouped.py
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import check
from portbench.reference import model as ref
from portbench.reference.adapter import PortWeights
from portbench.serve import port_model_config
from portbench.spec import ROOT, shape_from_config, small_shape
from portbench.weights import make_params
from repro_torch.core import (Request, TheoreticalCostModel, get_hardware,
                              make_scheduler)
from repro_torch.kernels import NoBackwardError
from repro_torch.kernels.moe_grouped.ops import row_counters
from repro_torch.kernels.moe_grouped.ref import route_reference
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.engine import _row_rungs
from repro_torch.serving.paged_plane import build_paged_fns, init_pools

#: float32 sums over d or f in another order (the plain version sums each
#: row in one fixed order, BLAS blocks it): ~1e-6 relative each, a few
#: products deep
ATOL = 2e-5
#: a whole small model, two layers deep, against the reference: the same
#: sums in other orders, through attention and the head
LOGIT_ATOL = 2e-4


def shape(num_experts=16, **kw):
    conf = json.loads((ROOT / "portbench" / "configs" /
                       "qwen3-moe-30b-a3b.json").read_text())
    m = small_shape(shape_from_config(conf))
    return dataclasses.replace(m, num_experts=num_experts,
                               experts_per_token=4, moe_d_ff=32,
                               num_shared_experts=0, **kw)


def layer(m, seed=3, dtype=torch.float32):
    params = make_params(m, seed, "cpu", dtype)
    cfg = port_model_config(m, str(dtype).split(".")[-1])
    return cfg, params, M.unstack_layers(params)[0]["moe"]


def tokens(m, n, seed):
    return torch.randn((n, m.d_model),
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("num_experts", [16, 14])
def test_grouped_equals_dense_and_reference(num_experts):
    """14 routed experts are padded to 16: the padding ones never route."""
    m = shape(num_experts)
    assert m.padded_experts == 16
    cfg, params, lp = layer(m)
    x = tokens(m, 22, 1).view(2, 11, -1) * 2.0
    y = moe.apply_moe_grouped(lp, cfg, x)
    assert torch.allclose(y, moe.apply_moe(lp, cfg, x), atol=ATOL)
    W = PortWeights(m, params).layer(0)
    want = ref.moe(m, W, x.reshape(22, -1).clone(), None)
    assert torch.allclose(y.reshape(22, -1), want, atol=ATOL)
    assert float(want.abs().max()) > 0.1
    ids, _ = route_reference(x.reshape(22, -1), lp["router"], 4,
                             num_experts)
    assert int(ids.max()) < num_experts


def test_inert_rows_route_nowhere():
    m = shape()
    cfg, _, lp = layer(m)
    x = tokens(m, 24, 2).view(3, 8, -1)
    valid = torch.ones((3, 8), dtype=torch.bool)
    valid[1, 5:] = False
    valid[2] = False
    stats = torch.zeros(2 * 16 + 2, dtype=torch.int64)
    y = moe.apply_moe_grouped(lp, cfg, x, valid=valid, stats=stats)
    full = moe.apply_moe_grouped(lp, cfg, x)
    assert torch.equal(y[valid], full[valid])
    assert torch.equal(y[~valid], torch.zeros_like(y[~valid]))
    live = int(valid.sum())
    assert int(stats[:16].sum()) == live * 4          # K rows a live token
    assert int(stats[32]) == min(16, live * 4)
    assert int(stats[16:32].sum()) == int((stats[:16] > 0).sum())
    none = torch.zeros_like(stats)
    moe.apply_moe_grouped(lp, cfg, x, valid=torch.zeros_like(valid),
                          stats=none)
    assert int(none.sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_alone_equals_row_in_batch(dtype):
    m = shape()
    cfg, _, lp = layer(m, dtype=dtype)
    x = tokens(m, 12, 4).to(dtype).view(2, 6, -1)
    full = moe.apply_moe_grouped(lp, cfg, x)
    for b in range(2):
        for s in range(6):
            one = moe.apply_moe_grouped(lp, cfg, x[b:b + 1, s:s + 1])
            assert torch.equal(one[0, 0], full[b, s]), (b, s)


def test_grouped_is_forward_only():
    m = shape()
    cfg, _, lp = layer(m)
    x = tokens(m, 4, 5).view(1, 4, -1).requires_grad_()
    with pytest.raises(NoBackwardError):
        moe.apply_moe_grouped(lp, cfg, x).sum().backward()


def test_paged_prefill_then_decode_match_reference(monkeypatch):
    """The pooled plane's steps with the grouped dispatch -- two chunked
    prefill rounds (the second with an inert row), then decode through
    the cache (one step with an inactive row) -- against the reference's
    full forward logits at every position the steps emit."""
    m = shape()
    cfg, params, _ = layer(m, seed=7)
    prefill, decode = build_paged_fns(cfg, moe_impl="grouped")
    page, npages = 8, 6
    kp, vp = init_pools(cfg, 2 * npages, page, nslots=2, device="cpu")
    bt = torch.arange(2 * npages, dtype=torch.int32).view(2, npages)
    rng = np.random.default_rng(0)
    seqs = [list(rng.integers(0, m.vocab_size, 19)),
            list(rng.integers(0, m.vocab_size, 7))]
    seen = []
    real = M._logits
    monkeypatch.setattr(M, "_logits",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    emitted = {0: [], 1: []}            # (position, logits) a sequence

    def grid(rows, width):
        t = torch.zeros((2, width), dtype=torch.int32)
        for b, toks in rows.items():
            t[b, :len(toks)] = torch.tensor(toks, dtype=torch.int32)
        return t

    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    ids = prefill(params, kp, vp, grid({0: seqs[0][:16], 1: seqs[1]}, 16),
                  i32([0, 0]), i32([16, 7]), bt)
    emitted[1].append((6, seen[-1][1]))
    seqs[1].append(int(ids[1]))
    ids = prefill(params, kp, vp, grid({0: seqs[0][16:]}, 16),
                  i32([16, 0]), i32([3, 0]), bt)
    emitted[0].append((18, seen[-1][0]))
    seqs[0].append(int(ids[0]))
    for step in range(3):
        active = torch.tensor([True, step != 1])
        ctx = i32([len(seqs[0]) - 1, len(seqs[1]) - 1])
        toks = i32([seqs[0][-1], seqs[1][-1]])
        ids = decode(params, kp, vp, toks, ctx, bt, active)
        for b in (0, 1):
            if active[b]:
                emitted[b].append((int(ctx[b]), seen[-1][b]))
                seqs[b].append(int(ids[b]))
    w = PortWeights(m, params)
    for b in (0, 1):
        pos = [p for p, _ in emitted[b]]
        got = torch.stack([lg[:m.vocab_size] for _, lg in emitted[b]])
        want = ref.logits_at(m, w, [torch.tensor(seqs[b][:max(pos) + 1])],
                             [torch.tensor(pos)])[0]
        assert torch.allclose(got, want, atol=LOGIT_ATOL), \
            (b, (got - want).abs().max())
        assert float(want.std()) > 0.1


def test_engine_serves_the_reference_with_grouped():
    """The engine on the pooled plane with the grouped dispatch: its rounds
    pack into the row rungs, every served token is the float32
    reference's best (gap at rounding), and the row accumulators count K
    rows a computed token in every layer."""
    m = shape()
    cfg, params, _ = layer(m, seed=11)
    sched = make_scheduler("vllm", 512, S=64, replacement="srf")
    eng = Engine(cfg, params, sched,
                 EngineConfig(nslots=9, cache_len=64, chunk=16, page_size=8,
                              plane="paged", moe_impl="grouped"),
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device="cpu").warmup()
    assert eng.rungs == _row_rungs(9) == [1, 8, 9]
    # warm-up is inert
    assert row_counters(eng.moe_stats, 16)["moe_routed_rows"] == 0
    rng = np.random.default_rng(5)
    lens = [(13, 6), (30, 4), (5, 9), (21, 3)]
    reqs = [Request(rid=i, input_len=I, output_len=O, arrival=0.0,
                    prompt=rng.integers(0, m.vocab_size, I).tolist())
            for i, (I, O) in enumerate(lens)]
    eng.run(reqs)
    assert sum(eng.prefill_rounds_by_rows.get(r, 0) for r in (1, 8)) > 0
    finished = {r.rid: (np.asarray(r.prompt), list(eng.outputs[r.rid]))
                for r in reqs}
    assert all(len(finished[i][1]) == O for i, (_, O) in enumerate(lens))
    reading = check.served_gaps(m, params, finished, sorted(finished),
                                "cpu")
    assert reading["max_logit_gap"] < 1e-3, reading
    c = row_counters(eng.moe_stats, m.num_experts)
    assert c["moe_routed_rows"] == m.num_layers * 4 * sum(
        I + O - 1 for I, O in lens)
    assert 0 < c["moe_experts_reached_share"] <= 100
    assert c["moe_expert_load_max_over_mean"] >= 1


def test_engine_refuses_nothing_of_grouped_off_the_pooled_plane():
    """The slot plane takes the grouped dispatch too (every row live, no
    accumulators) and serves the same tokens as the dense dispatch."""
    m = shape()
    cfg, params, _ = layer(m, seed=13)
    outs = {}
    for impl in ("dense", "grouped"):
        sched = make_scheduler("vllm", 256, S=64, replacement="srf")
        eng = Engine(cfg, params, sched,
                     EngineConfig(nslots=2, cache_len=48, chunk=16,
                                  moe_impl=impl),
                     cost_model=TheoreticalCostModel(cfg,
                                                     get_hardware("h100")),
                     device="cpu").warmup()
        assert eng.moe_stats is None and row_counters(None, 16) == {}
        rng = np.random.default_rng(2)
        reqs = [Request(rid=i, input_len=10, output_len=5, arrival=0.0,
                        prompt=rng.integers(0, m.vocab_size, 10).tolist())
                for i in range(3)]
        eng.run(reqs)
        outs[impl] = {r.rid: list(eng.outputs[r.rid]) for r in reqs}
    assert outs["dense"] == outs["grouped"]


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec_ = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


#: ``chip_smoke.py``'s full-width check cut to the CPU: d, f, E, K
SMALL_WIDTHS = (64, 32, 16, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_grouped_check_on_cpu(dtype):
    """Phase 30's check (``chip_smoke.check_grouped``) at a small width:
    the plain version, as the CPU dispatch runs it, passes with no token
    off; a layer that reads the next expert's down weights, or leaves
    the inert tokens' output unzeroed, fails."""
    from repro_torch.kernels.moe_grouped import ops
    from repro_torch.kernels.moe_grouped import ref as gref
    cs = _chip_smoke()
    case = cs.grouped_case(torch, 96, dtype, seed=5, widths=SMALL_WIDTHS,
                           device="cpu")
    assert 0 < int((~case["valid"]).sum()) < 96
    out = cs.check_grouped(torch, ops.moe_grouped, gref, case, "plain")
    assert out["tokens_off"] == 0 and out["max_abs_err"] == 0.0

    def next_expert(x, router, wg, wu, wo, **kw):
        return gref.moe_grouped_reference(x, router, wg, wu,
                                          wo.roll(1, 0).contiguous(), **kw)

    def inert_live(x, router, wg, wu, wo, valid, **kw):
        return gref.moe_grouped_reference(x, router, wg, wu, wo, **kw)

    for wrong in (next_expert, inert_live):
        with pytest.raises(RuntimeError, match="moe_grouped"):
            cs.check_grouped(torch, wrong, gref, case, wrong.__name__)


def test_chip_smoke_grouped_bound_hand_count():
    """Phase 30's bound counts the router, each reached expert's three
    matrices once, x and the output; operations 2 d E a token and
    2 x 3 d f a routed row."""
    cs = _chip_smoke()
    d, f, E, K = SMALL_WIDTHS
    case = cs.grouped_case(torch, 10, "bfloat16", seed=1,
                           widths=SMALL_WIDTHS, device="cpu")
    b = cs.grouped_bound(case, reached=7)
    assert b["ops"] == 2 * d * E * 10 + 2 * 3 * d * f * 10 * K
    assert b["bytes"] == 2 * (d * E + 3 * d * f * 7 + 2 * 10 * d)
    assert b["bound_by"] == "bytes"
