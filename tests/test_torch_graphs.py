"""The port's step graphs (``repro_torch.serving.step_graphs``) on the CPU,
the counterparts of the JAX engine's compiled-step tests
(``tests/test_paged_prefill_kernel.py::test_warmup_precompiles_every_
signature`` and ``tests/test_paged_plane.py::test_paged_compile_count_
constant``): ``warmup()`` builds every step graph the run loop can hit and
``run`` builds none; without a warmup the count does not grow with the
workload.  On the CPU every graph call runs its function eagerly over the
same static buffers a card's graph replays, so the buffer plumbing is
held here against the JAX engine: a decode cohort carried across prefill
rounds, the slot plane's in-place merge, and the launch-counter
accounting of a capture."""
import dataclasses
import importlib.util
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import Request as JRequest
from repro.core import TheoreticalCostModel as JCost
from repro.core import get_hardware as j_hw
from repro.core import make_scheduler as j_sched
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.core import Request as TRequest
from repro_torch.core import TheoreticalCostModel as TCost
from repro_torch.core import get_hardware as t_hw
from repro_torch.core import make_scheduler as t_sched
from repro_torch.core.invariants import InvariantError
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving.step_graphs import (StepGraphs, add_counts,
                                             counts_moved, read_counts)

from _torch_parity import params_pair, reduced_pair

torch.set_num_threads(2)

CACHE_LEN = 64


@pytest.fixture(scope="module")
def dense():
    jcfg, tcfg = reduced_pair()
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def rwkv():
    jcfg, tcfg = reduced_pair("rwkv6-7b")
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def spec(vocab, n, seed, max_i=25, max_o=9, gap=0.0):
    """(rid, input_len, output_len, arrival, prompt) rows: numpy-seeded
    mixed lengths (``tests/test_paged_plane.requests_for``'s), arrivals
    ``gap`` apart."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        I, O = int(rs.randint(4, max_i)), int(rs.randint(3, max_o))
        out.append((i, I, O, i * gap, rs.randint(0, vocab, size=I).tolist()))
    return out


def requests(R, rows):
    return [R(rid=i, input_len=I, output_len=O, arrival=a, prompt=list(p))
            for i, I, O, a, p in rows]


def engine(pkg, models, M_kv=60, nslots=4, page_size=8, sched="vllm",
           preempt_mode="recompute", plane="paged"):
    jcfg, tcfg, jp, tp = models
    skw = dict(S=128, replacement="srf", preempt_mode=preempt_mode)
    ekw = dict(nslots=nslots, cache_len=CACHE_LEN, chunk=16, plane=plane,
               page_size=page_size)
    if pkg == "jax":
        return JEngine(jcfg, jp, j_sched(sched, M_kv, **skw),
                       JEngineConfig(**ekw),
                       cost_model=JCost(jcfg, j_hw("tpu_v5e")))
    return TEngine(tcfg, tp, t_sched(sched, M_kv, **skw),
                   TEngineConfig(**ekw),
                   cost_model=TCost(tcfg, t_hw("tpu_v5e")), device="cpu")


def _strip(b):
    d = dataclasses.asdict(b)
    d.pop("wall_s")
    return d


# --------------------------------------------------------------------- #
# the graph count: warmup builds them all, run builds none
# --------------------------------------------------------------------- #

def prefill_keys(family):
    """The prefill graphs of 4 slots and the ladder (8, 16): the pooled
    plane's row rungs 1 and 4; the slot plane's one grid of every slot."""
    rungs = (1, 4) if family == "dense" else (4,)
    return [f"prefill/{r}x{b}" for r in rungs for b in (8, 16)]


@pytest.mark.parametrize("family,plane", [("dense", "paged"),
                                          ("rwkv", "batched"),
                                          ("rwkv", "paged")])
def test_warmup_builds_every_step_graph(dense, rwkv, family, plane):
    """``warmup()`` builds one graph per (row rung, ladder bucket) plus
    the decode graph -- on the pooled plane the rungs 1 and 4 of 4 slots,
    on the RWKV6 slot plane the one full grid -- and a preemption-free
    run builds none (``test_warmup_precompiles_every_signature``'s
    counterpart); ``num_compiles`` stays 0."""
    models = dense if family == "dense" else rwkv
    eng = engine("torch", models, M_kv=200, plane=plane,
                 page_size=8 if family == "dense" else 1)
    assert eng.num_graphs == 0
    eng.warmup()
    n0 = eng.num_graphs
    assert n0 == len(eng.rungs) * len(eng.buckets) + 1
    assert sorted(eng.graphs.graphs) == sorted(
        ["decode"] + prefill_keys(family))
    res = eng.run(requests(TRequest, spec(models[1].vocab_size, n=4,
                                          seed=1)))
    assert eng.num_graphs == n0
    assert eng.prefill_rounds > 0 and eng.decode_steps > 0
    assert res.num_compiles == eng.num_compiles == 0


def test_graph_count_does_not_grow_with_the_workload(dense):
    """Without a warmup the graphs are built at first use, one per step
    shape a round or step hits and never again, so a small and a large
    workload (swap churn) each end with one graph per prefill shape they
    ran plus the decode, within the (row rung, bucket) set
    (``test_paged_compile_count_constant``'s counterpart; the large
    workload's rounds hit a rung the small one's do not)."""
    counts = {}
    for tag, (n, seed) in {"small": (5, 2), "large": (11, 5)}.items():
        eng = engine("torch", dense, M_kv=50, preempt_mode="swap")
        shapes, build = set(), eng._prefill_graph

        def traced(bucket, rows, build=build, shapes=shapes):
            shapes.add((rows, bucket))
            return build(bucket, rows)
        eng._prefill_graph = traced
        res = eng.run(requests(TRequest, spec(dense[1].vocab_size, n=n,
                                              seed=seed, max_i=40)))
        assert res.metrics.num_preemptions > 0
        assert eng.num_graphs == len(shapes) + 1, (tag, shapes)
        assert eng.prefill_rounds > len(shapes), tag
        counts[tag] = eng.num_graphs
    assert counts["small"] <= counts["large"] \
        <= len(eng.rungs) * len(eng.buckets) + 1, counts


# --------------------------------------------------------------------- #
# the decode cohort lives in the decode graph's own buffer
# --------------------------------------------------------------------- #

def _traced(eng):
    """Record the order of the pooled plane's step calls: ``prefill``,
    ``upload`` (into the decode graph's cohort buffer) and ``decode``."""
    events = []

    def wrap(kind, fn):
        def call(*a):
            events.append(kind)
            return fn(*a)
        return call

    eng._paged_prefill = wrap("prefill", eng._paged_prefill)
    eng._paged_decode = wrap("decode", eng._paged_decode)
    upload = eng._upload

    def traced_upload(dst, host):
        if dst is eng._decode_graph().inputs[0]:
            events.append("upload")
        upload(dst, host)

    eng._upload = traced_upload
    return events


def test_cohort_survives_prefill_rounds_between_decodes(dense):
    """Sarathi's hybrid batches run a newcomer's prefill rounds between
    two decode steps of one unchanged cohort: the second decode uploads
    nothing (it reads what the first wrote into the decode graph's
    buffer), and tokens and ``BatchLog``s stay the JAX engine's."""
    rows = spec(dense[1].vocab_size, n=6, seed=7, max_i=40, max_o=12,
                gap=1e-6)
    res, events = {}, None
    for pkg, R in (("jax", JRequest), ("torch", TRequest)):
        eng = engine(pkg, dense, M_kv=400, nslots=4, sched="sarathi")
        if pkg == "torch":
            eng.warmup()
            events = _traced(eng)
        res[pkg] = eng.run(requests(R, rows))
    assert res["torch"].outputs == res["jax"].outputs
    jb, tb = res["jax"].metrics.batches, res["torch"].metrics.batches
    assert [_strip(b) for b in tb] == [_strip(b) for b in jb]
    # a decode, then prefill rounds, then a decode with no upload between
    seq = "".join({"prefill": "p", "decode": "d", "upload": "u"}[e]
                  for e in events)
    assert "dpd" in re.sub("p+", "p", seq), seq
    assert seq.count("d") == eng.decode_steps > seq.count("u") > 0


def test_replaced_pools_are_refused(dense):
    """A graph is bound to the pools and tables it was built against: a
    step after the pools were replaced by other tensors raises."""
    eng = engine("torch", dense).warmup()
    eng.k_pools = eng.k_pools.clone()
    eng.submit(TRequest(rid=0, input_len=5, output_len=2, arrival=0.0,
                        prompt=[1, 2, 3, 4, 5]))
    with pytest.raises(InvariantError, match="replaced"):
        eng.step()


# --------------------------------------------------------------------- #
# the slot plane's merge writes the engine's leaves in place
# --------------------------------------------------------------------- #

def test_slot_merge_in_place_keeps_inactive_slots(rwkv):
    """``_merge`` writes the active rows into the SAME leaf tensors (the
    graphs are bound to them) and leaves every inactive slot bit-equal."""
    eng = engine("torch", rwkv, plane="batched", page_size=1)
    gen = torch.Generator().manual_seed(3)
    for leaf in eng.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype)
                   if leaf.is_floating_point()
                   else torch.randint(0, 99, leaf.shape, generator=gen))
    leaves = {k: (v, v.data_ptr()) for k, v in eng.cache.items()}
    before = {k: v.clone() for k, v in eng.cache.items()}
    new = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
           if v.is_floating_point() else v + 1000
           for k, v in eng.cache.items()}
    active = torch.tensor([False, True, False, True])
    eng._merge(active, new)
    for k, leaf in eng.cache.items():
        assert leaf is leaves[k][0] and leaf.data_ptr() == leaves[k][1], k
        for s in range(4):
            got = leaf[s] if leaf.dim() == 1 else leaf[:, s]
            want = (new if active[s] else before)[k]
            want = want[s] if leaf.dim() == 1 else want[:, s]
            assert torch.equal(got, want), (k, s)


# --------------------------------------------------------------------- #
# launch counters under capture and replay
# --------------------------------------------------------------------- #

def _counter():
    c = SimpleNamespace(launches=0,
                        launches_by_variant={"mma": 0, "simt": 0})
    return c


def test_capture_accounting_keeps_launch_counts_true():
    """The accounting a capture does with a counting stub: the moves a
    captured call made are taken back out (a capture launches nothing)
    and added again at each replay, so after one eager call and three
    replays the counters read what four eager calls would."""
    a, b = _counter(), SimpleNamespace(launches=0)   # b: no variants

    def step():
        a.launches += 2
        a.launches_by_variant["mma"] += 2
        b.launches += 1

    step()                                  # the first, eager call
    before = read_counts((a, b))
    step()                                  # the captured call
    moved = counts_moved(before, read_counts((a, b)))
    add_counts((a, b), moved, sign=-1)
    assert read_counts((a, b)) == before
    for _ in range(3):                      # replays
        add_counts((a, b), moved)
    assert (a.launches, a.launches_by_variant, b.launches) == \
        (8, {"mma": 8, "simt": 0}, 4)


def test_step_graph_on_the_cpu_runs_every_call():
    """A CPU ``StepGraph`` runs its function at every call over its
    static input (no capture, so no accounting): the counting stub moves
    once per call, and the graph set counts every call as eager."""
    c = _counter()
    graphs = StepGraphs(counters=(c,))
    buf = torch.zeros(3, dtype=torch.int32)

    def fn(x):
        c.launches += 1
        c.launches_by_variant["simt"] += 1
        x.add_(1)
        return x * 2

    g = graphs.get("decode", lambda: (fn, (buf,), tuple))
    assert graphs.get("decode", None) is g and len(graphs) == 1
    for i in range(1, 4):
        assert torch.equal(g(), torch.full((3,), 2 * i, dtype=torch.int32))
    assert (c.launches, c.launches_by_variant) == (3, {"mma": 0, "simt": 3})
    assert (graphs.replays, graphs.eager_calls, g.graph) == (0, 3, None)
    assert g.shape == "(3,)"


# --------------------------------------------------------------------- #
# chip_smoke.py phase 20's replay-against-eager check, on the CPU
# --------------------------------------------------------------------- #

def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec_ = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family,plane", [("dense", "paged"),
                                          ("rwkv", "batched")])
def test_chip_smoke_replay_vs_eager_on_cpu(dense, rwkv, family, plane):
    """Phase 20's comparison at reduced size: every graph call of a warmed
    engine against the eager plane function on cloned state, from random
    state.  On the CPU the graph call is that function over the static
    buffers, so this holds the engine's plumbing: the grid's column order,
    the block tables, the decode graph's cohort advance (tokens <- ids,
    ctx += active) and the in-place merge, byte for byte."""
    cs = _chip_smoke()
    models = dense if family == "dense" else rwkv
    eng = engine("torch", models, M_kv=256, plane=plane,
                 page_size=8 if family == "dense" else 1).warmup()
    out = cs.replay_vs_eager(torch, eng, seed=5, device="cpu")
    assert sorted(out) == sorted(["decode"] + prefill_keys(family))
    for what, c in out.items():
        assert c["ids_equal"] and c["bit_equal"] and c["close"], (what, c)
    assert eng._bt_cache is None and eng._decode_state is None


def test_chip_smoke_moe_round_times_on_cpu(monkeypatch):
    """Phase 22's round timing at reduced size, its clock stubbed: it
    drives the full rung's graph (every slot a row, row b slot b) and the
    eager dense and sparse dispatch over the same grid."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "event_ms",
                        lambda torch, fn, iters=10, warm=2: (fn(), 0.0)[1])
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    eng = TEngine(cfg, params, t_sched("vllm", 512, S=256),
                  TEngineConfig(nslots=8, cache_len=64, chunk=16,
                                page_size=8, plane="paged"),
                  device="cpu").warmup()
    out = cs.moe_round_times(torch, eng, cfg, params)
    assert sorted(out) == ["decode_graph_ms", "prefill_eager_dense_ms",
                           "prefill_eager_sparse_ms", "prefill_graph_ms"]
    grid = eng._prefill_graph(eng.buckets[-1], 8).inputs[0]
    assert grid.shape == (8, eng.buckets[-1] + 3)
    assert torch.equal(grid[:, -1], torch.arange(8, dtype=torch.int32))
    assert bool((grid[:, -3] == eng.buckets[-1]).all())
