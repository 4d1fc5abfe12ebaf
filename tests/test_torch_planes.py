"""The port's slot-resident planes against the JAX package: the dense
chunk step (``prefill_chunk`` with and without ``length``), the decode
backends (``impl`` ``reference``, ``paged``, ``flash_jnp``), the
deferred-append decode and their helpers (``decode_attention_dense``,
``merge_softmax_groups``, ``decode_attn_partials``, the chunked flash
decode) at the model level; then ``Engine(device="cpu")`` on
``plane="batched"`` (dense, each ``impl``), ``decode_append="deferred"``
and ``plane="legacy"`` (dense and RWKV6) against the JAX engine with the
same settings under recompute, swap and ``auto`` preemption.

Tolerances.  Model level, fp32: K/V rows a call writes and the decode's
attention outputs to 2e-5 (``TOL``: XLA's and PyTorch's GEMMs sum in
different orders), logits to 1e-4 (``LOGIT_TOL``, as
``tests/test_torch_models.py``); every byte a call must not write (the
rest of the cache, padded positions, rows of length 0) bit-equal to its
input, in both packages; the port's padded chunk bit-equal to its
unpadded call.  Engine level: identical tokens, ``BatchLog``s (every
field but the measured ``wall_s``), preemption, swap and recovery counts.
The JAX ``impl="paged"`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does; the port's engine on ``impl="paged"`` is
held against the JAX engine on ``impl="reference"``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Request as JRequest
from repro.core import TheoreticalCostModel as JCost
from repro.core import get_hardware as j_hw
from repro.core import make_scheduler as j_sched
from repro.distributed import collectives as JCOL
from repro.kernels.paged_attention import ops as JPA
from repro.models import attention as JA
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.core import Request as TRequest
from repro_torch.core import TheoreticalCostModel as TCost
from repro_torch.core import get_hardware as t_hw
from repro_torch.core import make_scheduler as t_sched
from repro_torch.distributed import collectives as TCOL
from repro_torch.kernels.paged_attention import ops as TPA
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import generate_reference as t_reference

from _torch_parity import np_of, params_pair, reduced_pair, to_torch

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
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


def random_cache(cfg, index, seed=3, S=CACHE_LEN):
    """A dense cache of random K/V (numpy, from a seed) and ``index``."""
    rs = np.random.RandomState(seed)
    shape = (cfg.num_layers, len(index), S, cfg.num_kv_heads, cfg.head_dim_)
    return {"index": np.asarray(index, np.int32),
            "k": rs.randn(*shape).astype(np.float32),
            "v": rs.randn(*shape).astype(np.float32)}


def both(cache):
    return ({k: jnp.asarray(v) for k, v in cache.items()},
            {k: to_torch(v) for k, v in cache.items()})


def written(cache, start, n):
    """(L, B, S) bool: the cache positions a call writes (row b's
    ``n[b]`` tokens from ``start[b]``)."""
    L, B, S = cache["k"].shape[:3]
    pos = np.arange(S)[None, :]
    w = (pos >= np.asarray(start)[:, None]) \
        & (pos < (np.asarray(start) + np.asarray(n))[:, None])
    return np.broadcast_to(w[None], (L, B, S))


def check_cache(jc, tc, before, start, n):
    """Written positions: the two packages within ``TOL``; every other
    byte bit-equal to ``before`` in both."""
    w = written(before, start, n)
    for key in ("k", "v"):
        j, t = np.asarray(jc[key]), np_of(tc[key])
        np.testing.assert_array_equal(t[~w], before[key][~w])
        np.testing.assert_array_equal(j[~w], before[key][~w])
        np.testing.assert_allclose(t[w], j[w], **TOL)
    np.testing.assert_array_equal(np_of(tc["index"]), np.asarray(jc["index"]))


# --------------------------------------------------------------------- #
# the dense chunk step
# --------------------------------------------------------------------- #

#: rows: from empty; mid-cache; a chunk ending at cache_len (its padded
#: positions wrap past the end); a length-0 row
CHUNK_START = [0, 5, 50, 20]
CHUNK_LEN = [16, 7, 14, 0]


@pytest.mark.parametrize("padded", [True, False], ids=["length", "exact"])
def test_prefill_chunk_dense_matches_jax(dense, padded):
    """JAX's ``prefill_chunk`` against the port's on one random cache:
    logits of the real rows to ``LOGIT_TOL``, written K/V to ``TOL``,
    every other byte (padded positions, the length-0 row) untouched in
    both packages."""
    jcfg, tcfg, jp, tp = dense
    start = CHUNK_START if padded else [0, 5, 40, 20]
    before = random_cache(jcfg, start)
    rs = np.random.RandomState(4)
    toks = rs.randint(0, jcfg.vocab_size, size=(4, 16)).astype(np.int32)
    kw_j, kw_t, n = {}, {}, [16] * 4
    if padded:
        kw_j["length"] = jnp.asarray(np.int32(CHUNK_LEN))
        kw_t["length"] = to_torch(np.int32(CHUNK_LEN))
        n = CHUNK_LEN
    jcache, tcache = both(before)
    jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(toks), jcache, **kw_j)
    tl, tc = TM.prefill_chunk(tcfg, tp, to_torch(toks), tcache, **kw_t)
    live = np.asarray(n) > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               **LOGIT_TOL)
    check_cache(jc, tc, before, start, n)
    np.testing.assert_array_equal(tc["index"].numpy(),
                                  np.asarray(start) + np.asarray(n))
    for k, v in tcache.items():          # the input is not modified
        np.testing.assert_array_equal(v.numpy(), before[k])


def test_padded_chunk_bit_equal_to_unpadded(dense):
    """The JAX contract (``tests/test_engine_plane.py::test_padded_chunk_
    matches_unpadded``) on the port: a 16-token bucket carrying
    ``length`` real tokens leaves every leaf bit-equal to the unpadded
    call of those tokens -- also where the padding wraps past
    ``cache_len`` -- and a length-0 row does not move."""
    _, tcfg, _, tp = dense
    before = random_cache(tcfg, CHUNK_START)
    toks = np.random.RandomState(5).randint(
        0, tcfg.vocab_size, size=(4, 16)).astype(np.int32)
    _, padded = TM.prefill_chunk(tcfg, tp, to_torch(toks),
                                 both(before)[1],
                                 length=to_torch(np.int32(CHUNK_LEN)))
    for b, n in enumerate(CHUNK_LEN):
        row = {k: v[b:b + 1] if k == "index" else v[:, b:b + 1]
               for k, v in before.items()}
        if n == 0:
            plain = both(row)[1]
        else:
            _, plain = TM.prefill_chunk(tcfg, tp, to_torch(toks[b:b + 1, :n]),
                                        both(row)[1])
        for k in plain:
            got = padded[k][b] if k == "index" else padded[k][:, b]
            want = plain[k][0] if k == "index" else plain[k][:, 0]
            assert torch.equal(got, want), (b, k)


def test_chunk_longer_than_cache_raises(dense):
    _, tcfg, _, tp = dense
    cache = TM.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="chunk of 9 tokens > cache length"):
        TM.prefill_chunk(tcfg, tp, torch.zeros((1, 9), dtype=torch.int32),
                         cache)


# --------------------------------------------------------------------- #
# decode backends and the deferred append
# --------------------------------------------------------------------- #

#: from empty, mid-cache, the last slot (the context fills the cache)
DECODE_INDEX = [0, 5, 63, 20]


@pytest.mark.parametrize("fn", ["decode_step", "decode_step_deferred"])
@pytest.mark.parametrize("impl", ["reference", "paged", "flash_jnp"])
def test_decode_matches_jax(dense, impl, fn):
    """JAX's decode with the same ``impl`` (``paged``: its Pallas kernel
    in interpret mode, ``cache_len`` 64 = one 64-token page) against the
    port's: logits to ``LOGIT_TOL``, the new K/V row to ``TOL``, the rest
    of the cache untouched."""
    jcfg, tcfg, jp, tp = dense
    before = random_cache(jcfg, DECODE_INDEX)
    toks = np.random.RandomState(6).randint(
        0, jcfg.vocab_size, size=(4,)).astype(np.int32)
    jcache, tcache = both(before)
    jl, jc = getattr(JM, fn)(jcfg, jp, jnp.asarray(toks), jcache, impl=impl)
    tl, tc = getattr(TM, fn)(tcfg, tp, to_torch(toks), tcache, impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    check_cache(jc, tc, before, DECODE_INDEX, [1] * 4)


@pytest.mark.parametrize("impl", ["paged", "flash_jnp"])
def test_decode_impls_equal_reference(dense, impl):
    """Within the port: every backend's logits and new K/V rows equal the
    reference decode's to ``TOL`` (a later layer's row depends on the
    earlier layers' attention), the first layer's cache bit for bit."""
    _, tcfg, _, tp = dense
    before = random_cache(tcfg, DECODE_INDEX)
    toks = torch.tensor([3, 1, 4, 1])
    ref = TM.decode_step(tcfg, tp, toks, both(before)[1])
    got = TM.decode_step(tcfg, tp, toks, both(before)[1], impl=impl)
    torch.testing.assert_close(got[0], ref[0], **TOL)
    for k in ref[1]:
        torch.testing.assert_close(got[1][k], ref[1][k], **TOL)
        assert torch.equal(got[1][k][0], ref[1][k][0]), k


def test_deferred_equals_inline_decode(dense, rwkv):
    """``decode_step_deferred`` against ``decode_step`` in the port: the
    dense logits to ``TOL`` (the fp32 two-group merge) and the caches
    bit-equal (the same row written once); RWKV6's step is the inline one,
    bit for bit."""
    _, tcfg, _, tp = dense
    before = random_cache(tcfg, DECODE_INDEX)
    toks = torch.tensor([2, 7, 1, 8])
    inline = TM.decode_step(tcfg, tp, toks, both(before)[1])
    deferred = TM.decode_step_deferred(tcfg, tp, toks, both(before)[1])
    torch.testing.assert_close(deferred[0], inline[0], **TOL)
    for k in inline[1]:
        torch.testing.assert_close(deferred[1][k], inline[1][k], **TOL)
    _, rcfg, _, rp = rwkv
    cache = TM.init_cache(rcfg, 2, CACHE_LEN, device="cpu")
    toks = torch.tensor([[5, 6, 7], [1, 2, 3]])
    _, cache = TM.prefill_chunk(rcfg, rp, toks, cache)
    a = TM.decode_step(rcfg, rp, torch.tensor([9, 4]), cache)
    b = TM.decode_step_deferred(rcfg, rp, torch.tensor([9, 4]), cache)
    assert torch.equal(a[0], b[0])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


def test_rwkv_deferred_decode_matches_jax(rwkv):
    """RWKV6's deferred step (its states are the delta) against JAX's,
    from a prefilled cache: logits to ``LOGIT_TOL``, states to ``TOL``."""
    jcfg, tcfg, jp, tp = rwkv
    toks = np.random.RandomState(8).randint(
        0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    _, jcache = JM.prefill_chunk(jcfg, jp, jnp.asarray(toks),
                                 JM.init_cache(jcfg, 2, CACHE_LEN))
    _, tcache = TM.prefill_chunk(tcfg, tp, to_torch(toks),
                                 TM.init_cache(tcfg, 2, CACHE_LEN,
                                               device="cpu"))
    nxt = np.int32([11, 12])
    jl, jc = JM.decode_step_deferred(jcfg, jp, jnp.asarray(nxt), jcache)
    tl, tc = TM.decode_step_deferred(tcfg, tp, to_torch(nxt), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for k in jc:
        np.testing.assert_allclose(np_of(tc[k]), np.asarray(jc[k]), **TOL)


# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #

def _qkv(seed, B=3, H=8, Hkv=2, S=128, D=16):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, D).astype(np.float32),
            rs.randn(B, S, Hkv, D).astype(np.float32),
            rs.randn(B, S, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("page_size", [64, 32])
def test_decode_attention_dense_matches_jax(page_size):
    """The contiguous cache viewed as pages: the port's CPU path (the
    paged decode's plain version through identity tables) against JAX's
    ``decode_attention_dense`` (its Pallas kernel in interpret mode) and
    against plain softmax attention over the first ``ctx`` keys, to
    ``TOL``; contexts of 1, a page edge, and the full cache."""
    q, k, v = _qkv(0)
    ctx = np.int32([1, page_size, 128])
    want = JPA.decode_attention_dense(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(ctx),
                                      page_size=page_size)
    got = TPA.decode_attention_dense(*to_torch(q, k, v, ctx),
                                     page_size=page_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    qt, kt, vt = to_torch(q, k, v)
    valid = torch.arange(128)[None] < torch.from_numpy(ctx)[:, None]
    plain = TA._sdpa(qt[:, None], kt, vt, valid[:, None, :])[:, 0]
    torch.testing.assert_close(got, plain, **TOL)


def test_decode_attention_dense_refuses_a_partial_page():
    q, k, v = to_torch(*_qkv(1, S=96))
    with pytest.raises(ValueError, match="not a multiple of the page size"):
        TPA.decode_attention_dense(q, k, v, torch.full((3,), 5,
                                                       dtype=torch.int32))


@pytest.mark.parametrize("S,chunk", [(128, 1024), (96, 64), (128, 32)])
def test_sdpa_flash_decode_matches_jax(S, chunk):
    """The chunked online-softmax decode (JAX's chunk rule: ``min(chunk,
    S)`` halved until it divides S) against JAX's, to ``TOL``; contexts
    of 0 (no visible key), 1 and the full cache."""
    q, k, v = _qkv(2, S=S)
    lens = np.int32([0, 1, S])
    want = JA._sdpa_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens),
                                 chunk=chunk)
    got = TA._sdpa_flash_decode(*to_torch(q, k, v, lens), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_partials_matches_jax(dtype):
    """(out, m, l) against JAX's ``decode_attn_partials`` with rows of 0,
    40 and all 128 valid keys: fp32 to ``TOL``; bf16 inputs (exact
    products, fp32 sums in both) out to 2e-2, m and l to ``TOL`` relative
    to l's scale."""
    q, k, v = _qkv(3)
    valid = np.arange(128)[None, :] < np.array([0, 40, 128])[:, None]
    jt = (lambda a: jnp.asarray(a, jnp.bfloat16)) if dtype == "bfloat16" \
        else jnp.asarray
    want = JCOL.decode_attn_partials(jt(q), jt(k), jt(v), jnp.asarray(valid))
    got = TCOL.decode_attn_partials(*to_torch(q, k, v,
                                              dtype=getattr(torch, dtype)),
                                    torch.from_numpy(valid))
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np_of(got[0]), np_of(want[0]), **tol)
    np.testing.assert_allclose(np_of(got[1]), np_of(want[1]), **TOL)
    np.testing.assert_allclose(np_of(got[2]), np_of(want[2]), rtol=1e-4)


def test_merge_softmax_groups_matches_jax():
    """The two-group merge against JAX's, to ``TOL``, with an empty first
    group (m = -1e30, as an empty cache gives) in one row."""
    rs = np.random.RandomState(9)
    out1, v2 = rs.randn(3, 4, 8).astype(np.float32), \
        rs.randn(3, 4, 8).astype(np.float32)
    m1, s2 = rs.randn(3, 4).astype(np.float32), \
        rs.randn(3, 4).astype(np.float32)
    l1 = rs.rand(3, 4).astype(np.float32) * 5
    m1[0] = -1e30
    want = JA.merge_softmax_groups(*(jnp.asarray(a)
                                     for a in (out1, m1, l1, s2, v2)))
    got = TA.merge_softmax_groups(*to_torch(out1, m1, l1, s2, v2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------- #
# the engine's planes against the JAX engine
# --------------------------------------------------------------------- #

def requests_spec(vocab, n=5, seed=0):
    """``tests/test_engine.py::requests_for``: prompts of 8-24 tokens and
    3-8 output tokens, as (rid, input_len, output_len, arrival, prompt)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        I, O = int(rs.randint(8, 25)), int(rs.randint(3, 9))
        out.append((i, I, O, 0.0, rs.randint(0, vocab, size=I).tolist()))
    return out


MODES = ("recompute", "swap", "auto")
#: (family, port settings, JAX settings or None for the same) per plane;
#: the port's impl="paged" is held against the JAX engine's reference
PLANES = {
    "batched": ("dense", dict(plane="batched"), None),
    "batched_paged": ("dense", dict(plane="batched", impl="paged"),
                      dict(plane="batched")),
    "deferred": ("dense", dict(plane="batched", decode_append="deferred"),
                 None),
    "legacy": ("dense", dict(plane="legacy"), None),
    "rwkv_legacy": ("rwkv", dict(plane="legacy"), None),
    "rwkv_deferred": ("rwkv", dict(plane="batched",
                                   decode_append="deferred"), None),
    "batched_flash_jnp": ("dense", dict(plane="batched", impl="flash_jnp"),
                          None),
}
#: every plane under each mode; the flash_jnp backend under recompute
RUNS = [(p, m) for p in PLANES if p != "batched_flash_jnp" for m in MODES] \
    + [("batched_flash_jnp", "recompute")]


def _engine(pkg, models, ekw, mode):
    """``tests/test_engine.py``'s setting: vLLM + SRF, M=60, 4 slots,
    ``cache_len`` 64, chunk 16, page 1 (the JAX default)."""
    jcfg, tcfg, jp, tp = models
    ekw = dict(nslots=4, cache_len=CACHE_LEN, chunk=16, page_size=1, **ekw)
    skw = dict(S=128, replacement="srf", preempt_mode=mode)
    if pkg == "jax":
        return JEngine(jcfg, jp, j_sched("vllm", 60, **skw),
                       JEngineConfig(share_jits=True, **ekw),
                       cost_model=JCost(jcfg, j_hw("tpu_v5e")))
    return TEngine(tcfg, tp, t_sched("vllm", 60, **skw), TEngineConfig(**ekw),
                   cost_model=TCost(tcfg, t_hw("tpu_v5e")), device="cpu")


@pytest.fixture(scope="module")
def runs(dense, rwkv):
    """Each run once per package (the JAX results shared between the
    port's runs that hold against the same JAX settings)."""
    out, jax_res = {}, {}
    for plane, mode in RUNS:
        family, tkw, jkw = PLANES[plane]
        models = dense if family == "dense" else rwkv
        spec = requests_spec(models[0].vocab_size)
        jkw = tkw if jkw is None else jkw
        key = (family, tuple(sorted(jkw.items())), mode)
        if key not in jax_res:
            jax_res[key] = _engine("jax", models, jkw, mode).run(
                [JRequest(rid=i, input_len=I, output_len=O, arrival=a,
                          prompt=list(p)) for i, I, O, a, p in spec])
        eng = _engine("torch", models, tkw, mode).warmup()
        res = eng.run([TRequest(rid=i, input_len=I, output_len=O, arrival=a,
                                prompt=list(p)) for i, I, O, a, p in spec])
        out[(plane, mode)] = (spec, jax_res[key], res, eng)
    return out


def _strip(b):
    d = dataclasses.asdict(b)
    d.pop("wall_s")
    return d


def _counts(res):
    """Every ``swap_stats``/``recovery_stats`` key but the measured wall
    ones, and the metrics' preemption and swap counts."""
    d = {k: v for k, v in {**res.swap_stats, **res.recovery_stats}.items()
         if not k.startswith("wall_")}
    d.update(preemptions=res.metrics.num_preemptions,
             num_swaps=res.metrics.num_swaps)
    return d


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_outputs_identical_to_jax_engine(runs, run):
    _, j, t, _ = runs[run]
    assert t.outputs == j.outputs


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_batch_schedule_identical_to_jax_engine(runs, run):
    _, j, t, _ = runs[run]
    assert len(t.metrics.batches) == len(j.metrics.batches)
    assert [_strip(b) for b in t.metrics.batches] == \
        [_strip(b) for b in j.metrics.batches]


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_preemption_and_swap_counts_identical(runs, run):
    """The counts key by key; every run preempts, a swap run swaps (each
    snapshot restored), and the store is empty at the end."""
    _, j, t, eng = runs[run]
    assert _counts(t) == _counts(j)
    assert t.metrics.num_preemptions > 0
    if run[1] == "swap":
        st = t.swap_stats
        assert st["swap_outs"] == st["swap_ins"] > 0 and st["kv_in"] > 0
    assert len(eng.swap_store) == 0 and not eng._pending_swaps


@pytest.mark.parametrize("run", [r for r in RUNS if r[1] == "recompute"],
                         ids="-".join)
def test_tokens_equal_reference(runs, dense, rwkv, run):
    """Each plane's tokens are ``generate_reference``'s (the dense ones
    with the plane's own decode ``impl``)."""
    family, tkw, _ = PLANES[run[0]]
    _, tcfg, _, tp = dense if family == "dense" else rwkv
    spec, _, t, _ = runs[run]
    for rid, _, O, _, prompt in spec:
        assert t.outputs[rid] == t_reference(
            tcfg, tp, prompt, O, cache_len=CACHE_LEN,
            impl=tkw.get("impl", "reference"), device="cpu"), rid


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_step_graph_counts(runs, run):
    """``warmup`` built every graph the plane runs (``len(buckets) + 1``;
    the decode graph alone on the legacy plane, whose prefill is eager),
    ``run`` built none, and every graph call was one prefill round or
    decode step (on the CPU each is an eager call of the graph's
    function); ``num_compiles`` stays 0."""
    _, _, t, eng = runs[run]
    legacy = PLANES[run[0]][1]["plane"] == "legacy"
    n = 1 if legacy else len(eng.buckets) + 1
    assert eng.num_graphs == n and t.num_compiles == 0
    steps = eng.decode_steps + (0 if legacy else eng.prefill_rounds)
    assert eng.graphs.eager_calls == n + steps
    assert eng.prefill_rounds > 0 and eng.decode_steps > 0


def test_legacy_counts_one_round_per_chunk_call(dense):
    """On the legacy plane ``prefill_rounds`` counts its exact-shape chunk
    calls (each runs every layer's prefill kernel once), the chunk calls
    see one row and no ``length``, and ``decode_steps`` counts the decode
    graph's calls."""
    eng = _engine("torch", dense, dict(plane="legacy"), "recompute")
    calls = {"chunk": [], "decode": 0}

    def chunk(params, tokens, cache, lengths):
        calls["chunk"].append((tuple(tokens.shape), lengths))
        return fn(params, tokens, cache, lengths)

    def decode(*a):
        calls["decode"] += 1
        return dfn(*a)

    fn, dfn = eng._chunk_fn, eng._decode_fn
    eng._chunk_fn, eng._decode_fn = chunk, decode
    spec = requests_spec(dense[1].vocab_size, n=3, seed=4)
    eng.run([TRequest(rid=i, input_len=I, output_len=O, arrival=a,
                      prompt=p) for i, I, O, a, p in spec])
    assert len(calls["chunk"]) == eng.prefill_rounds > len(spec)
    assert all(shape[0] == 1 and 1 <= shape[1] <= 16 and lens is None
               for shape, lens in calls["chunk"])
    assert calls["decode"] == eng.decode_steps > 0


def test_dense_slot_plane_warmup_and_claims_touch_only_their_slots(dense):
    """Warmup runs every bucket and the decode step with no live row: the
    cache stays bit for bit and the step counters do not move.  Claiming a
    slot zeroes that slot's K/V rows and index, and only them."""
    eng = _engine("torch", dense, dict(plane="batched"), "recompute")
    for leaf in eng.cache.values():
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng.warmup()
    for k in before:
        assert torch.equal(eng.cache[k], before[k]), k
    assert (eng.prefill_rounds, eng.decode_steps) == (0, 0)
    slot = eng._claim_slot(7)
    for k, v in eng.cache.items():
        axis = 0 if v.dim() == 1 else 1
        assert not v.select(axis, slot).any(), k
        rest = torch.tensor([s for s in range(4) if s != slot])
        assert torch.equal(v.index_select(axis, rest),
                           before[k].index_select(axis, rest)), k
