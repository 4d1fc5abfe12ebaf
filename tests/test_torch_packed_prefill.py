"""The pooled plane's packed prefill round on the CPU: a round's
prefilling rows go into the smallest row rung (powers of eight below
``nslots``, then ``nslots``) of a ``(rows, bucket + 3)`` grid ``[toks |
lens | starts | slot]``, each row reading its slot's block table.

* A round of n prefilling rows picks the smallest rung that holds them,
  and ``prefill_rounds``, ``prefill_rounds_by_rows``,
  ``prefill_tokens`` and ``prefill_grid_tokens`` count what ran.
* ``prefill_fn`` on the packed grid against the same rows placed at their
  slots in the full ``(nslots, bucket)`` grid: equal sampled ids, the
  K/V rows written equal within ``TOL``, and every other pool byte (other
  pages, the sentinel pages, what inert rows would touch) bit-equal to
  its input on both grids.
* ``warmup`` builds the largest grid first.

This file imports neither JAX nor the JAX package; the engine's tokens
and ``BatchLog`` schedules against the JAX engine are held by
``tests/test_torch_engine.py`` and the other parity files.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (Request, TheoreticalCostModel, get_hardware,
                              make_scheduler)
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.engine import _row_rungs
from repro_torch.serving.paged_plane import build_paged_fns, init_pools

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
NSLOTS = 12
PAGE = 8
CHUNK = 16
CACHE_LEN = 64


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    return cfg, M.init_params(cfg, 0, device="cpu")


def _engine(cfg, params, nslots=NSLOTS):
    sched = make_scheduler("vllm", 1024, S=1024, replacement="srf")
    return Engine(cfg, params, sched,
                  EngineConfig(nslots=nslots, cache_len=CACHE_LEN,
                               chunk=CHUNK, page_size=PAGE, plane="paged"),
                  cost_model=TheoreticalCostModel(cfg,
                                                  get_hardware("tpu_v5e")),
                  device="cpu")


def test_rungs_follow_from_nslots():
    assert _row_rungs(1) == [1]
    assert _row_rungs(4) == [1, 4]
    assert _row_rungs(8) == [1, 8]
    assert _row_rungs(12) == [1, 8, 12]
    assert _row_rungs(32) == [1, 8, 32]
    assert _row_rungs(100) == [1, 8, 64, 100]


@pytest.mark.parametrize("n,rung", [(1, 1), (2, 8), (3, 8), (5, 8),
                                    (8, 8), (9, 32), (32, 32)])
def test_a_round_of_n_rows_takes_the_smallest_rung(model, n, rung):
    """n requests admitted together on 32 slots prefill in one round of
    one rung; the counters count that round and its grid."""
    cfg, params = model
    eng = _engine(cfg, params, nslots=32)
    rs = np.random.RandomState(n)
    lens = [int(x) for x in rs.randint(3, CHUNK + 1, size=n)]
    for i, k in enumerate(lens):
        eng.submit(Request(rid=i, input_len=k, output_len=2, arrival=0.0,
                           prompt=rs.randint(0, cfg.vocab_size,
                                             size=k).tolist()))
    assert eng.step() == n
    bucket = eng._bucket_for(max(lens))
    assert eng._rows_for(n) == rung
    assert eng.prefill_rounds == 1
    assert eng.prefill_rounds_by_rows == {rung: 1}
    assert eng.prefill_tokens == sum(lens)
    assert eng.prefill_grid_tokens == rung * bucket
    assert f"prefill/{rung}x{bucket}" in eng.graphs.graphs
    assert all(len(eng.outputs[i]) == 1 for i in range(n))


def test_counters_add_up_over_a_served_run(model):
    """Over a whole run (a backlog on 4 slots, prompts past one chunk)
    every round is counted once, under the rung it ran on."""
    cfg, params = model
    eng = _engine(cfg, params, nslots=4)
    rs = np.random.RandomState(3)
    reqs = []
    for i in range(9):
        k = int(rs.randint(4, 40))
        reqs.append(Request(rid=i, input_len=k, output_len=int(
            rs.randint(2, 6)), arrival=0.0,
            prompt=rs.randint(0, cfg.vocab_size, size=k).tolist()))
    res = eng.run(reqs)
    assert res.metrics.num_preemptions == 0
    by = eng.prefill_rounds_by_rows
    assert sum(by.values()) == eng.prefill_rounds > 0
    assert set(by) <= set(eng.rungs) and len(by) > 1
    assert eng.prefill_tokens == sum(r.input_len for r in reqs)
    assert eng.prefill_tokens <= eng.prefill_grid_tokens


def test_warmup_builds_the_largest_grid_first(model):
    cfg, params = model
    eng = _engine(cfg, params).warmup()
    keys = [k for k in eng.graphs.graphs if k.startswith("prefill/")]
    sizes = [int(a) * int(b) for a, b in
             (k.split("/")[1].split("x") for k in keys)]
    assert len(keys) == len(eng.rungs) * len(eng.buckets)
    assert sizes == sorted(sizes, reverse=True)
    assert keys[0] == f"prefill/{NSLOTS}x{CHUNK}"
    assert list(eng.graphs.graphs)[-1] == "decode"


def _written(starts, lens, tables, num_pages):
    """(pool pages, page) bool: the positions the real rows write."""
    mask = torch.zeros((num_pages, PAGE), dtype=torch.bool)
    for s, n, row in zip(starts.tolist(), lens.tolist(), tables):
        for pos in range(s, s + n):
            mask[int(row[pos // PAGE]), pos % PAGE] = True
    return mask


@pytest.mark.parametrize("n", [1, 3, 5, NSLOTS])
def test_packed_grid_equals_the_full_grid(model, n):
    cfg, params = model
    prefill_fn, _ = build_paged_fns(cfg)
    gen = torch.Generator().manual_seed(n)
    maxp = CACHE_LEN // PAGE
    num_pages = NSLOTS * maxp
    k0, v0 = init_pools(cfg, num_pages, PAGE, nslots=NSLOTS, device="cpu")
    k0.copy_(torch.randn(k0.shape, generator=gen))
    v0.copy_(torch.randn(v0.shape, generator=gen))
    bt = torch.randperm(num_pages, generator=gen)[:NSLOTS * maxp] \
        .view(NSLOTS, maxp).to(torch.int32)
    bucket = CHUNK
    slots = torch.randperm(NSLOTS, generator=gen)[:n].to(torch.int32)
    lens = torch.randint(1, bucket + 1, (n,), generator=gen,
                         dtype=torch.int32)
    lens[0] = bucket
    starts = torch.randint(0, CACHE_LEN - bucket + 1, (n,), generator=gen,
                           dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (n, bucket), generator=gen,
                         dtype=torch.int32)
    rows = next(r for r in _row_rungs(NSLOTS) if r >= n)

    def grid(R, at):
        g_toks = torch.zeros((R, bucket), dtype=torch.int32)
        g_lens, g_starts = (torch.zeros(R, dtype=torch.int32)
                            for _ in range(2))
        g_toks[at], g_lens[at], g_starts[at] = toks, lens, starts
        return g_toks, g_starts, g_lens

    full = grid(NSLOTS, slots.long())
    kf, vf = k0.clone(), v0.clone()
    ids_full = prefill_fn(params, kf, vf, *full, bt)
    packed = grid(rows, torch.arange(n))
    g_slots = torch.zeros(rows, dtype=torch.int32)
    g_slots[:n] = slots
    kp, vp = k0.clone(), v0.clone()
    ids_packed = prefill_fn(params, kp, vp, *packed,
                            bt.index_select(0, g_slots))
    assert ids_packed.shape == (rows,)
    assert torch.equal(ids_packed[:n], ids_full[slots.long()])
    mask = _written(starts, lens, bt[slots.long()], k0.shape[1])
    assert int(mask.sum()) == int(lens.sum())
    for got, want, before in ((kp, kf, k0), (vp, vf, v0)):
        torch.testing.assert_close(got[:, mask], want[:, mask], **TOL)
        assert not torch.equal(got[:, mask], before[:, mask])
        for after in (got, want):
            assert torch.equal(after[:, ~mask], before[:, ~mask])
