"""The port's mixture-of-experts family against the JAX package on the
CPU: the layer (``models.moe``: the dense dispatch, and the sparse one
with and without capacity overflow, dropping the same tokens), the
padding experts, the model functions with ``moe_impl="dense"`` and
``"sparse"``, and the engine on ``tests/test_engine.py``'s qwen2-moe
workload (tokens and ``BatchLog`` schedules equal to the JAX engine's on
the pooled and slot planes).  Inputs and weights are made from a seed
with numpy and handed to both packages."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Request as JRequest
from repro.core import TheoreticalCostModel as JCost
from repro.core import get_hardware as j_hw
from repro.core import make_scheduler as j_sched
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import generate_reference as j_reference
from repro_torch.core import Request as TRequest
from repro_torch.core import TheoreticalCostModel as TCost
from repro_torch.core import get_hardware as t_hw
from repro_torch.core import make_scheduler as t_sched
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import generate_reference as t_reference

from _torch_parity import params_pair, reduced_pair

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: tests/test_torch_models.py's tolerances: one layer, and logits
TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
#: reduced qwen2-moe has a shared expert, reduced qwen3-moe has none
ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def moe_models(request):
    jcfg, tcfg = reduced_pair(request.param)
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _x(cfg, B, S, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(B, S, cfg.d_model)
            * scale).astype(np.float32)


def _jax_slots(topi, E, C):
    """``repro.models.moe.apply_moe_sparse``'s buffer rows and keep mask."""
    flat_e = topi.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    keep = pos < C
    return flat_e * C + jnp.where(keep, pos, 0), keep


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #

def test_init_moe_tree_and_scales(moe_models):
    jcfg, tcfg, jp, _ = moe_models
    tp = TM.init_params(tcfg, 0, device="cpu")
    jt = jp["layers"]["moe"]
    assert set(tp["layers"]["moe"]) == set(jt)
    for k, v in tp["layers"]["moe"].items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                assert tuple(vv.shape) == jt[k][kk].shape, (k, kk)
        else:
            assert tuple(v.shape) == jt[k].shape, k
    E, d, f = tcfg.padded_experts, tcfg.d_model, tcfg.moe_d_ff
    for k, scale in (("wi_gate", d ** -0.5), ("wo", f ** -0.5)):
        std = float(tp["layers"]["moe"][k].std())
        assert abs(std / scale - 1) < 0.1, (k, std, scale)
    assert "mlp" not in tp["layers"]


@pytest.mark.parametrize("impl,cf", [("dense", None), ("sparse", 1.25),
                                     ("sparse", 8.0)])
def test_moe_layer_matches_jax(moe_models, impl, cf):
    """One layer's dispatch, x (2, 16, d) from a seed, against JAX.  The
    sparse cases at T = 4 and 32 tokens: capacity 1.25 overflows there
    (asserted), 8.0 does not; either way the port keeps and drops the
    same (token, k) entries as JAX, and the outputs agree."""
    jcfg, tcfg, jp, tp = moe_models
    jl, tl = _layer0(jp["layers"]["moe"]), _layer0(tp["layers"]["moe"])
    for B, S in ((2, 16), (1, 4)):
        x = _x(jcfg, B, S, seed=B * 10 + S)
        if impl == "dense":
            want = jmoe.apply_moe(jl, jcfg, jnp.asarray(x))
            got = tmoe.apply_moe(tl, tcfg, torch.from_numpy(x))
        else:
            want = jmoe.apply_moe_sparse(jl, jcfg, jnp.asarray(x),
                                         capacity_factor=cf)
            got = tmoe.apply_moe_sparse(tl, tcfg, torch.from_numpy(x),
                                        capacity_factor=cf)
            T, E = B * S, tcfg.padded_experts
            C = tmoe.capacity(tcfg, T, cf)
            assert C == max(1, int(cf * T * jcfg.experts_per_token / E))
            xt = x.reshape(T, -1)
            logits = (jnp.asarray(xt) @ jl["router"]).astype(jnp.float32)
            jidx, jkeep = _jax_slots(jax.lax.top_k(logits, jcfg
                                                   .experts_per_token)[1],
                                     E, C)
            _, topi = tmoe.route(tl, tcfg, torch.from_numpy(xt))
            tidx, tkeep = tmoe.dispatch_slots(topi, E, C)
            np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
            if cf == 1.25 and T == 4:
                assert not tkeep.all(), "the case must overflow"
            if cf == 8.0:
                assert tkeep.all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_dispatch_is_bit_reproducible(moe_models):
    """No scatter-add: repeated calls give the same bits (with drops)."""
    _, tcfg, _, tp = moe_models
    tl = _layer0(tp["layers"]["moe"])
    x = torch.from_numpy(_x(tcfg, 2, 8, seed=3))
    first = tmoe.apply_moe_sparse(tl, tcfg, x)
    for _ in range(3):
        assert torch.equal(tmoe.apply_moe_sparse(tl, tcfg, x), first)
    assert torch.equal(tmoe.apply_moe(tl, tcfg, x),
                       tmoe.apply_moe(tl, tcfg, x))


def test_sparse_matches_dense_without_overflow(moe_models):
    _, tcfg, _, tp = moe_models
    tl = _layer0(tp["layers"]["moe"])
    x = torch.from_numpy(_x(tcfg, 1, 16, seed=4, scale=0.5))
    np.testing.assert_allclose(
        tmoe.apply_moe_sparse(tl, tcfg, x, capacity_factor=8.0).numpy(),
        tmoe.apply_moe(tl, tcfg, x).numpy(), rtol=2e-4, atol=2e-4)


def test_moe_padded_experts_get_zero_weight():
    """tests/test_models.py's padding test: with 3 experts padded to 4,
    the router never picks the pad, so its weights play no part."""
    _, tcfg = reduced_pair("qwen2-moe-a2.7b")
    tcfg = dataclasses.replace(tcfg, num_experts=3, expert_pad_multiple=4)
    assert tcfg.padded_experts == 4
    tl = _layer0(TM.init_params(tcfg, 0, device="cpu")["layers"]["moe"])
    x = torch.from_numpy(_x(tcfg, 2, 8, seed=5))
    _, topi = tmoe.route(tl, tcfg, x.reshape(16, -1))
    assert int(topi.max()) < tcfg.num_experts
    moe_p = dict(tl)
    for k in ("wi_gate", "wi_up", "wo"):
        moe_p[k] = tl[k].clone()
        moe_p[k][tcfg.num_experts:] = 1234.5
    for fn in (tmoe.apply_moe, tmoe.apply_moe_sparse):
        np.testing.assert_allclose(fn(moe_p, tcfg, x).numpy(),
                                   fn(tl, tcfg, x).numpy(), atol=1e-5)


def test_ep_dispatch_names_its_roadmap_item(moe_models):
    """The expert-parallel dispatch needs a mesh: without one it raises
    JAX's ``set_mesh`` error (tests/test_torch_distributed.py runs it
    under one)."""
    _, tcfg, _, tp = moe_models
    x = torch.zeros(1, 2, tcfg.d_model)
    with pytest.raises(ValueError, match="set_mesh"):
        tmoe.apply_moe_ep(_layer0(tp["layers"]["moe"]), tcfg, x)
    with pytest.raises(ValueError, match="set_mesh"):
        TM.prefill(tcfg, tp, {"tokens": torch.zeros(1, 2, dtype=torch.long)},
                   cache_len=8, moe_impl="ep")


# --------------------------------------------------------------------- #
# the model functions
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("moe_impl", ["dense", "sparse"])
def test_prefill_chunk_and_decode_match_jax(moe_models, moe_impl):
    """``prefill`` (2 x 12 prompt), then a padded ``prefill_chunk`` (rows
    of 5 and 2 real tokens in a bucket of 8), then 3 ``decode_step``s:
    logits and caches against JAX's at fp32 logit tolerance."""
    jcfg, tcfg, jp, tp = moe_models
    rs = np.random.RandomState(7)
    toks = rs.randint(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        cache_len=32, moe_impl=moe_impl)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks).long()},
                        cache_len=32, moe_impl=moe_impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    chunk = rs.randint(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    length = np.int32([5, 2])
    jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc,
                              moe_impl=moe_impl, length=jnp.asarray(length))
    tl, tc = TM.prefill_chunk(tcfg, tp, torch.from_numpy(chunk).long(), tc,
                              moe_impl=moe_impl,
                              length=torch.from_numpy(length))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tc["index"].numpy(),
                                  np.asarray(jc["index"]))
    nxt = np.array(jnp.argmax(jl[:, :jcfg.vocab_size], axis=-1), np.int32)
    for _ in range(3):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc,
                                moe_impl=moe_impl)
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tc,
                                moe_impl=moe_impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **LOGIT_TOL)
        nxt = np.array(jnp.argmax(jl[:, :jcfg.vocab_size], axis=-1),
                       np.int32)


def test_decode_deferred_matches_jax(moe_models):
    jcfg, tcfg, jp, tp = moe_models
    toks = np.random.RandomState(8).randint(
        0, jcfg.vocab_size, size=(2, 6)).astype(np.int32)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=16,
                       moe_impl="dense")
    _, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks).long()},
                       cache_len=16, moe_impl="dense")
    cur = np.int32([3, 5])
    jl, _ = JM.decode_step_deferred(jcfg, jp, jnp.asarray(cur), jc,
                                    moe_impl="dense")
    tl, _ = TM.decode_step_deferred(tcfg, tp, torch.from_numpy(cur).long(),
                                    tc, moe_impl="dense")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


# --------------------------------------------------------------------- #
# the engine: tests/test_engine.py's qwen2-moe workload
# --------------------------------------------------------------------- #

def _engine_requests(vocab, n=5, seed=0):
    """``tests/test_engine.requests_for``: prompts of 8-24 tokens, 3-8
    outputs, as (rid, I, O, prompt) rows."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        I, O = int(rs.randint(8, 25)), int(rs.randint(3, 9))
        out.append((i, I, O, rs.randint(0, vocab, size=I).tolist()))
    return out


#: plane -> EngineConfig settings beyond tests/test_engine.py's (nslots
#: 4, cache_len 64, chunk 16; page_size 1 and the batched plane by default)
ENGINE_RUNS = {"batched": {},
               "paged": dict(plane="paged", page_size=8),
               "batched_sparse": dict(moe_impl="sparse")}


@pytest.fixture(scope="module")
def qwen2():
    jcfg, tcfg = reduced_pair("qwen2-moe-a2.7b")
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def engine_runs(qwen2):
    jcfg, tcfg, jp, tp = qwen2
    spec = _engine_requests(jcfg.vocab_size)
    out = {}
    for name, ekw in ENGINE_RUNS.items():
        ekw = dict(nslots=4, cache_len=64, chunk=16, **ekw)
        skw = dict(S=128, replacement="srf")
        res = {}
        for pkg, R in (("jax", JRequest), ("torch", TRequest)):
            reqs = [R(rid=i, input_len=I, output_len=O, arrival=0.0,
                      prompt=list(p)) for i, I, O, p in spec]
            if pkg == "jax":
                eng = JEngine(jcfg, jp, j_sched("vllm", 60, **skw),
                              JEngineConfig(**ekw),
                              cost_model=JCost(jcfg, j_hw("tpu_v5e")))
            else:
                eng = TEngine(tcfg, tp, t_sched("vllm", 60, **skw),
                              TEngineConfig(**ekw),
                              cost_model=TCost(tcfg, t_hw("tpu_v5e")),
                              device="cpu")
            res[pkg] = eng.run(reqs)
        out[name] = res
    return spec, out


def _strip(b):
    d = dataclasses.asdict(b)
    d.pop("wall_s")
    return d


@pytest.mark.parametrize("name", list(ENGINE_RUNS))
def test_engine_matches_jax_engine(engine_runs, name):
    _, runs = engine_runs
    j, t = runs[name]["jax"], runs[name]["torch"]
    assert t.outputs == j.outputs
    assert [_strip(b) for b in t.metrics.batches] == \
        [_strip(b) for b in j.metrics.batches]
    assert t.metrics.num_preemptions == j.metrics.num_preemptions > 0


@pytest.mark.parametrize("name", ["batched", "paged"])
def test_engine_tokens_equal_both_references(qwen2, engine_runs, name):
    jcfg, tcfg, jp, tp = qwen2
    spec, runs = engine_runs
    for rid, _, O, prompt in spec:
        want = t_reference(tcfg, tp, prompt, O, cache_len=64, device="cpu")
        assert runs[name]["torch"].outputs[rid] == want, rid
        assert j_reference(jcfg, jp, prompt, O, cache_len=64) == want


def test_engine_refuses_unknown_moe_impl(qwen2):
    _, tcfg, _, tp = qwen2
    with pytest.raises(ValueError, match="unknown moe_impl"):
        TEngine(tcfg, tp, t_sched("vllm", 60, S=128),
                TEngineConfig(moe_impl="top1"), device="cpu")


def test_serve_cli_runs_moe_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for arch in ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--arch", arch],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert f"arch={arch}-reduced" in proc.stderr
