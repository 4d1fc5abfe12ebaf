"""The port's hybrid family (hymba: sliding-window attention beside the
selective SSM) against the JAX package on the CPU, at the reduced config
(2 layers, d 64, 4 q / 2 kv heads of 16, window 32, SSM 128 x 4).

Module level: ``models.ssm`` (the full-sequence form with and without a
carried state and a ``length`` mask, a row of length 0 among them; the
doubling scan; the decode step) and the four window branches of
``models.attention`` (a prefill cropped to the ring, a chunk across the
ring's wrap with padded rows, decode and deferred decode past the wrap,
B1's dense view on a 64-slot ring).  Model level: the JAX package's own
hymba tests (``tests/test_models.py``, ``tests/test_engine_plane.py``)
run on the port and held against JAX.

Tolerances.  fp32 throughout.  A module's outputs and states to 2e-5
(``TOL``: XLA's and PyTorch's GEMMs sum in different orders, and JAX's
``associative_scan`` associates the SSM's products otherwise than the
port's doubling scan); the JAX tests' own tolerances where they are
ported (logits 2e-4, uneven chunks 3e-4, deferred against inline
2e-5); logits against JAX 1e-4 (``LOGIT_TOL``, as the other parity
tests)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.training import make_loss_fn, value_and_grad

from _torch_parity import np_of, params_pair, reduced_pair, to_torch

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NAME = "hymba-1.5b"


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = reduced_pair(NAME)
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _jax_layer0(jp, key):
    return jax.tree.map(lambda a: a[0], jp["layers"][key])


def _x(cfg, B, S, seed):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model) \
        .astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np_of(got), np_of(want), **tol)


# --------------------------------------------------------------------- #
# params and cache
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_structure_matches_jax(dtype):
    """The same tree, shapes and dtypes as JAX's ``init_params`` (the
    SSM's ``A_log`` and ``D`` fp32 in a bf16 model), the published init
    values where they are deterministic."""
    jcfg, tcfg = reduced_pair(NAME, dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, 0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = {tuple(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        t = flat_t[key]
        assert tuple(t.shape) == leaf.shape, key
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
    ssm = tp["layers"]["ssm"]
    N = tcfg.ssm_state
    np.testing.assert_allclose(
        ssm["A_log"].numpy(),
        np.broadcast_to(np.log(np.arange(1, N + 1, dtype=np.float32)),
                        ssm["A_log"].shape), rtol=1e-6)
    assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
    assert not ssm["dt_bias"].any()


def test_init_cache_matches(models):
    """The ring is ``min(cache_len, window)`` slots; ``h`` fp32 and
    ``conv`` in the model dtype, all zero, as JAX's."""
    jcfg, tcfg, _, _ = models
    jc = JM.init_cache(jcfg, 3, 64)
    tc = TM.init_cache(tcfg, 3, 64, device="cpu")
    assert set(tc) == set(jc) == {"index", "k", "v", "h", "conv"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_array_equal(np_of(tc[k]), np.asarray(jc[k]))
    assert tc["k"].shape[2] == tcfg.window
    assert tc["h"].dtype == torch.float32


def test_check_supported_serves_and_refuses_training(models):
    """The hybrid family serves and, since A8-ii, trains: the loss and the
    SSM's gradients (through ``ssm.ChunkScan``) against JAX's
    ``train_loss``, with the layer recomputed (remat) and without."""
    jcfg, tcfg, jp, tp = models
    TM.check_supported(tcfg)
    TM.check_supported(tcfg, train=True)
    toks = _toks(jcfg, 2, 12, seed=26)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jl, jg = jax.value_and_grad(lambda p: JM.train_loss(jcfg, p, batch))(jp)
    t = torch.from_numpy(toks).long()
    for remat in (True, False):
        tl, tg = value_and_grad(make_loss_fn(tcfg, remat=remat))(
            tp, {"tokens": t, "labels": t})
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        for k in ("A_log", "bc_proj", "dt_proj", "dt_bias", "in_proj"):
            _close(tg["layers"]["ssm"][k], jg["layers"]["ssm"][k])


# --------------------------------------------------------------------- #
# models.ssm
# --------------------------------------------------------------------- #

def _ssm_state(cfg, B, seed):
    rs = np.random.RandomState(seed)
    return {"h": rs.randn(B, cfg.d_inner, cfg.ssm_state).astype(np.float32),
            "conv": rs.randn(B, JS.CONV_K - 1, cfg.d_inner)
            .astype(np.float32)}


@pytest.mark.parametrize("S,chunk,length,state", [
    (16, 128, None, False),
    (40, 16, None, True),           # JAX: 5 chunks of 8; the port 16/16/8
    (24, 8, [24, 9, 0], True),      # padded rows and a row of length 0
    (13, 128, [13, 1, 0], False),
])
def test_apply_ssm_full_matches_jax(models, S, chunk, length, state):
    jcfg, tcfg, jp, tp = models
    jl, tl = _jax_layer0(jp, "ssm"), _layer0(tp["layers"]["ssm"])
    B = 3
    x = _x(jcfg, B, S, seed=S)
    st = _ssm_state(jcfg, B, seed=S + 1) if state else None
    ln = None if length is None else np.int32(length)
    jy, jst = JS.apply_ssm_full(
        jl, jcfg, jnp.asarray(x), chunk=chunk,
        state=None if st is None else {k: jnp.asarray(v)
                                       for k, v in st.items()},
        length=None if ln is None else jnp.asarray(ln))
    ty, tst = TS.apply_ssm_full(
        tl, tcfg, torch.from_numpy(x), chunk=chunk,
        state=None if st is None else {k: torch.from_numpy(v)
                                       for k, v in st.items()},
        length=None if ln is None else torch.from_numpy(ln))
    rows = slice(None) if ln is None else ln > 0
    _close(ty[rows], np.asarray(jy)[rows])
    for k in ("h", "conv"):
        assert tst[k].dtype == (torch.float32)
        _close(tst[k], jst[k])
    if ln is not None and st is not None:
        # a row of length 0 carries its state through bit for bit
        for k in ("h", "conv"):
            np.testing.assert_array_equal(np_of(tst[k])[ln == 0],
                                          st[k][ln == 0])


def test_causal_conv_matches_jax(models):
    """The depthwise causal conv over a zero-padded sequence and over a
    stream that carries its left context."""
    jcfg, _, jp, tp = models
    w = _layer0(tp["layers"]["ssm"])["conv_w"]
    jw = _jax_layer0(jp, "ssm")["conv_w"]
    x = np.random.RandomState(4).randn(2, 9, jcfg.d_inner).astype(np.float32)
    _close(TS._conv_full(torch.from_numpy(x), w),
           JS._conv_full(jnp.asarray(x), jw))
    _close(TS._conv_window(torch.from_numpy(x), w, 6),
           JS._conv_window(jnp.asarray(x), jw, 6))


@pytest.mark.parametrize("Q", [1, 2, 5, 8, 37, 128])
def test_doubling_scan_matches_jax_associative_scan(Q):
    rs = np.random.RandomState(Q)
    a = rs.uniform(0.2, 1.0, size=(2, Q, 6, 4)).astype(np.float32)
    b = rs.randn(2, Q, 6, 4).astype(np.float32)
    want = JS._ssm_core_scan(jnp.asarray(a), jnp.asarray(b))
    got = TS._ssm_core_scan(*to_torch(a.copy(), b.copy()))
    _close(got, want)


def test_apply_ssm_decode_matches_jax_over_8_steps(models):
    jcfg, tcfg, jp, tp = models
    jl, tl = _jax_layer0(jp, "ssm"), _layer0(tp["layers"]["ssm"])
    st = _ssm_state(jcfg, 2, seed=5)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = {k: torch.from_numpy(v) for k, v in st.items()}
    xs = _x(jcfg, 2, 8, seed=6)
    for t in range(8):
        jy, js = JS.apply_ssm_decode(jl, jcfg, jnp.asarray(xs[:, t:t + 1]),
                                     js)
        ty, ts = TS.apply_ssm_decode(tl, tcfg,
                                     torch.from_numpy(xs[:, t:t + 1]), ts)
        _close(ty, jy)
        for k in ("h", "conv"):
            _close(ts[k], js[k])


def test_ssm_full_continues_like_decode(models):
    """One full-sequence call equals the same steps decoded one by one
    (the port's own two forms, from one carried state)."""
    _, tcfg, _, tp = models
    tl = _layer0(tp["layers"]["ssm"])
    st = {k: torch.from_numpy(v) for k, v in
          _ssm_state(tcfg, 2, seed=9).items()}
    x = torch.from_numpy(_x(tcfg, 2, 6, seed=10))
    y_full, st_full = TS.apply_ssm_full(tl, tcfg, x, state=st)
    ys, cur = [], st
    for t in range(6):
        y, cur = TS.apply_ssm_decode(tl, tcfg, x[:, t:t + 1], cur)
        ys.append(y)
    torch.testing.assert_close(y_full, torch.cat(ys, 1), **TOL)
    for k in ("h", "conv"):
        torch.testing.assert_close(st_full[k], cur[k], **TOL)


# --------------------------------------------------------------------- #
# models.attention: the window branches
# --------------------------------------------------------------------- #

def _ring(cfg, B, seed, S=None):
    rs = np.random.RandomState(seed)
    shape = (B, S or cfg.window, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": rs.randn(*shape).astype(np.float32),
            "v": rs.randn(*shape).astype(np.float32)}


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_attention_full_crops_the_ring(models, impl):
    """S = 48 over the 32-slot window: the window mask, and the cache's
    last 32 K/V rolled into ring order (row = position mod 32); the
    port's ``impl="flash"`` (its plain version here) against JAX's
    reference."""
    jcfg, tcfg, jp, tp = models
    jl, tl = _jax_layer0(jp, "attn"), _layer0(tp["layers"]["attn"])
    x = _x(jcfg, 2, 48, seed=12)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48)).copy()
    jo, jc = JA.attention_full(jl, jcfg, jnp.asarray(x), jnp.asarray(pos),
                               cache_len=jcfg.window)
    to, tc = TA.attention_full(tl, tcfg, torch.from_numpy(x),
                               torch.from_numpy(pos).long(), impl=impl,
                               cache_len=tcfg.window)
    _close(to, jo)
    for k in ("k", "v"):
        assert tc[k].shape[1] == tcfg.window
        _close(tc[k], jc[k])
    # position p sits in row p mod 32: the roll put the 48 - 32 = 16 newest
    # positions at the ring's head
    _, full = TA.attention_full(tl, tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos).long(), cache_len=48)
    for p in range(16, 48):
        assert torch.equal(tc["k"][:, p % 32], full["k"][:, p])


def test_attention_full_refuses_to_crop_full_attention(models):
    _, tcfg, _, tp = models
    lp = _layer0(tp["layers"]["attn"])
    dense = dataclasses.replace(tcfg, window=0)
    with pytest.raises(ValueError, match="cache_len 16 < prompt length 20"):
        TA.attention_full(lp, dense, torch.zeros((1, 20, tcfg.d_model)),
                          torch.arange(20)[None], cache_len=16)


#: rows: a ring that wraps inside the chunk; a full ring; a fresh row
#: (``start - 1 = -1``) padded; a row of length 0
CHUNK_START = [20, 40, 0, 9]
CHUNK_LEN = [16, 9, 5, 0]


def test_attention_chunk_across_the_wrap_with_padded_rows(models):
    """Attend before writing: the keys are the old ring (each slot's
    position rebuilt from ``start - 1``) and the chunk, then the chunk
    is written at ``position mod 32``.  Real rows' outputs and every
    cache byte against JAX; the bytes of padded tokens and of the
    length-0 row are the input's, bit for bit."""
    jcfg, tcfg, jp, tp = models
    jl, tl = _jax_layer0(jp, "attn"), _layer0(tp["layers"]["attn"])
    B, c = len(CHUNK_START), 16
    x = _x(jcfg, B, c, seed=14)
    ring = _ring(jcfg, B, seed=15)
    start, length = np.int32(CHUNK_START), np.int32(CHUNK_LEN)
    jo, jc = JA.attention_chunk(jl, jcfg, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in ring.items()},
                                jnp.asarray(start), length=jnp.asarray(length))
    to, tc = TA.attention_chunk(tl, tcfg, torch.from_numpy(x),
                                {k: torch.from_numpy(v)
                                 for k, v in ring.items()},
                                torch.from_numpy(start),
                                length=torch.from_numpy(length))
    real = np.arange(c)[None, :] < length[:, None]
    _close(np_of(to)[real], np.asarray(jo)[real])
    slots = (start[:, None] + np.arange(c)[None, :]) % jcfg.window
    for k in ("k", "v"):
        got = np_of(tc[k])
        _close(got, jc[k])
        for b in range(B):
            kept = np.setdiff1d(np.arange(jcfg.window),
                                slots[b, :length[b]])
            np.testing.assert_array_equal(got[b, kept], ring[k][b, kept])


def test_attention_chunk_refuses_a_ring_of_another_size(models):
    _, tcfg, _, tp = models
    lp = _layer0(tp["layers"]["attn"])
    ring = {k: torch.from_numpy(v) for k, v in
            _ring(tcfg, 1, seed=1, S=64).items()}
    with pytest.raises(ValueError, match="exactly window-sized"):
        TA.attention_chunk(lp, tcfg, torch.zeros((1, 4, tcfg.d_model)), ring,
                           torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="chunk of 40 tokens > cache"):
        TA.attention_chunk(lp, tcfg, torch.zeros((1, 40, tcfg.d_model)),
                           {k: v[:, :32] for k, v in ring.items()},
                           torch.zeros((1,), dtype=torch.int32))


#: decode indices: a fresh ring, one short of full, the first wrap, laps
DECODE_INDEX = [0, 31, 32, 70]


@pytest.mark.parametrize("deferred", [False, True], ids=["inline",
                                                         "deferred"])
def test_attention_decode_past_the_wrap(models, deferred):
    """Inline: the new token written at ``index mod 32``, then
    ``min(index + 1, 32)`` keys attended.  Deferred: the ring read as it
    stands, the slot the new token will overwrite masked once the ring is
    full (its position ``index - 32`` left the window)."""
    jcfg, tcfg, jp, tp = models
    jl, tl = _jax_layer0(jp, "attn"), _layer0(tp["layers"]["attn"])
    B = len(DECODE_INDEX)
    x = _x(jcfg, B, 1, seed=16)
    ring = _ring(jcfg, B, seed=17)
    idx = np.int32(DECODE_INDEX)
    fj = JA.attention_decode_deferred if deferred else JA.attention_decode
    ft = TA.attention_decode_deferred if deferred else TA.attention_decode
    jo, jc = fj(jl, jcfg, jnp.asarray(x),
                {k: jnp.asarray(v) for k, v in ring.items()},
                jnp.asarray(idx))
    to, tc = ft(tl, tcfg, torch.from_numpy(x),
                {k: torch.from_numpy(v) for k, v in ring.items()},
                torch.from_numpy(idx))
    _close(to, jo)
    assert set(tc) == set(jc)
    for k in tc:
        _close(tc[k], jc[k])


def test_attention_decode_refuses_a_ring_longer_than_the_window(models):
    _, tcfg, _, tp = models
    lp = _layer0(tp["layers"]["attn"])
    ring = {k: torch.from_numpy(v) for k, v in
            _ring(tcfg, 1, seed=2, S=64).items()}
    with pytest.raises(ValueError, match="longer than the window"):
        TA.attention_decode(lp, tcfg, torch.zeros((1, 1, tcfg.d_model)),
                            ring, torch.zeros((1,), dtype=torch.int32))


def test_paged_decode_on_a_64_slot_ring_matches_jax(models):
    """``impl="paged"`` (B1's dense view, whose pages are 64 slots, so the
    window is 64 here): the port's CPU path against JAX's attention
    decode with its Pallas kernel in interpret mode, past the wrap."""
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (dataclasses.replace(c, window=64) for c in (jcfg, tcfg))
    jl, tl = _jax_layer0(jp, "attn"), _layer0(tp["layers"]["attn"])
    idx = np.int32([0, 63, 64, 130])
    x = _x(jcfg, len(idx), 1, seed=18)
    ring = _ring(jcfg, len(idx), seed=19)
    jo, jc = JA.attention_decode(jl, jcfg, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in ring.items()},
                                 jnp.asarray(idx), impl="paged")
    to, tc = TA.attention_decode(tl, tcfg, torch.from_numpy(x),
                                 {k: torch.from_numpy(v)
                                  for k, v in ring.items()},
                                 torch.from_numpy(idx), impl="paged")
    _close(to, jo)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    ref, _ = TA.attention_decode(tl, tcfg, torch.from_numpy(x),
                                 {k: torch.from_numpy(v)
                                  for k, v in ring.items()},
                                 torch.from_numpy(idx))
    torch.testing.assert_close(to, ref, **TOL)


# --------------------------------------------------------------------- #
# the model: the JAX package's hymba tests, run on the port
# --------------------------------------------------------------------- #

def _toks(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _jit(fn, cfg, **kw):
    return jax.jit(lambda *a: fn(cfg, *a, **kw))


def test_chunked_prefill_parity(models):
    """``tests/test_models.py::test_chunked_prefill_parity``: three chunks
    of 16 over the 32-slot ring (S = 48 wraps it) equal one full prefill
    (2e-4), and decode from both caches; held against JAX's prefill."""
    jcfg, tcfg, jp, tp = models
    B, S, Smax = 2, 48, tcfg.window
    toks = _toks(jcfg, B, S, seed=20)
    jl, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       cache_len=Smax)
    lf, cache_f = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)
                                        .long()}, cache_len=Smax)
    cache = TM.init_cache(tcfg, B, Smax, device="cpu")
    for i in range(0, S, 16):
        lc, cache = TM.prefill_chunk(
            tcfg, tp, torch.from_numpy(toks[:, i:i + 16]).long(), cache)
    tol = dict(rtol=2e-4, atol=2e-4)
    _close(lc, lf, tol)
    _close(lf, jl, LOGIT_TOL)
    nxt = torch.argmax(lf, -1)
    d1, _ = TM.decode_step(tcfg, tp, nxt, cache_f)
    d2, _ = TM.decode_step(tcfg, tp, nxt, cache)
    _close(d1, d2, tol)


def test_uneven_chunk_sizes_parity(models):
    """``tests/test_models.py::test_uneven_chunk_sizes_parity``: chunks
    of 1, 7, 16 and 13 (S = 37 wraps the ring) equal the full prefill
    (3e-4), held against JAX's prefill."""
    jcfg, tcfg, jp, tp = models
    toks = _toks(jcfg, 1, 37, seed=21)
    jl, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       cache_len=jcfg.window)
    cache = TM.init_cache(tcfg, 1, tcfg.window, device="cpu")
    ofs = 0
    for c in (1, 7, 16, 13):
        lc, cache = TM.prefill_chunk(
            tcfg, tp, torch.from_numpy(toks[:, ofs:ofs + c]).long(), cache)
        ofs += c
    _close(lc, jl, dict(rtol=3e-4, atol=3e-4))


def test_deferred_decode_matches_inline(models):
    """``tests/test_models.py::test_deferred_decode_matches_inline`` for
    hymba: S = 40 over the 32-slot ring, 4 steps (the scatter at
    ``index mod 32``) in lockstep at 2e-5, every cache leaf too; and the
    inline steps against JAX's jitted decode."""
    jcfg, tcfg, jp, tp = models
    toks = _toks(jcfg, 2, 40, seed=22)
    jlg, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         cache_len=jcfg.window)
    lg, cache = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)
                                      .long()}, cache_len=tcfg.window)
    jdec = _jit(JM.decode_step, jcfg)
    ci, cd = cache, dict(cache)
    cur_i = cur_d = torch.argmax(lg, -1)
    for _ in range(4):
        li, ci = TM.decode_step(tcfg, tp, cur_i, ci)
        ld, cd = TM.decode_step_deferred(tcfg, tp, cur_d, cd)
        jli, jc = jdec(jp, jnp.asarray(cur_i.numpy()), jc)
        torch.testing.assert_close(li, ld, **TOL)
        _close(li, jli, LOGIT_TOL)
        cur_i, cur_d = torch.argmax(li, -1), torch.argmax(ld, -1)
    assert set(ci) == set(cd)
    for k in ci:
        torch.testing.assert_close(ci[k].float(), cd[k].float(), **TOL)
        _close(ci[k], jc[k])


def test_padded_chunk_matches_unpadded(models):
    """``tests/test_engine_plane.py::test_padded_chunk_matches_unpadded``
    for hymba: a bucketed chunk with a ``length`` mask leaves every leaf
    within 2e-5 of the unpadded call (padding changes the SSM scan's
    factorization), the K/V ring bit-equal, and a length-0 row
    untouched; the padded call's leaves against JAX's."""
    jcfg, tcfg, jp, tp = models
    toks = _toks(jcfg, 2, 13, seed=7)
    grid = np.zeros((2, 16), np.int32)
    grid[:, :13] = toks
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    _, plain = TM.prefill_chunk(tcfg, tp, t(toks),
                                TM.init_cache(tcfg, 2, 64, device="cpu"))
    lens = torch.tensor([13, 13], dtype=torch.int32)
    _, padded = TM.prefill_chunk(tcfg, tp, t(grid),
                                 TM.init_cache(tcfg, 2, 64, device="cpu"),
                                 length=lens)
    _, jpad = JM.prefill_chunk(jcfg, jp, jnp.asarray(grid),
                               JM.init_cache(jcfg, 2, 64),
                               length=jnp.asarray(lens.numpy()))
    for k in plain:
        if k in ("k", "v", "index"):
            assert torch.equal(plain[k], padded[k]), k
        torch.testing.assert_close(plain[k], padded[k], **TOL)
        _close(padded[k], jpad[k])
    before = {k: v.clone() for k, v in padded.items()}
    _, after = TM.prefill_chunk(tcfg, tp, t(grid), padded,
                                length=torch.tensor([3, 0],
                                                    dtype=torch.int32))
    for k in before:       # leaves are (L, B, ...), the index (B,)
        row = (lambda a: a[:, 1]) if before[k].dim() > 1 else \
            (lambda a: a[1])
        assert torch.equal(row(before[k]), row(after[k])), k


def test_sliding_window_restricts_attention():
    """``tests/test_models.py::test_sliding_window_restricts_attention`` on
    the port: a dense config with hymba's window (the SSM branch off);
    tokens beyond the layered receptive field (L x window) cannot move the
    output; the logits against JAX's."""
    over = dict(ssm_state=0, ssm_heads=0, family="dense")
    jcfg, tcfg = reduced_pair(NAME, **over)
    jp, tp = params_pair(jcfg)
    S = tcfg.num_layers * tcfg.window + 8
    toks = _toks(jcfg, 1, S, seed=23)
    toks2 = toks.copy()
    toks2[0, 0] = (toks2[0, 0] + 1) % tcfg.vocab_size
    l1, _ = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks).long()},
                       cache_len=tcfg.window)
    l2, _ = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks2).long()},
                       cache_len=tcfg.window)
    torch.testing.assert_close(l1, l2, rtol=0, atol=1e-5)
    jl, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       cache_len=jcfg.window)
    _close(l1, jl, LOGIT_TOL)


def test_prefill_and_decode_with_the_flash_impl_match_jax(models):
    """``prefill(impl="flash")`` (on the CPU the kernel's plain version,
    with the window) and ``decode_step(impl="paged")`` over a 64-slot
    ring against JAX's reference path, S = 80 past the window."""
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (dataclasses.replace(c, window=64) for c in (jcfg, tcfg))
    toks = _toks(jcfg, 2, 80, seed=24)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        cache_len=64)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks).long()},
                        cache_len=64, impl="flash")
    _close(tl, jl, LOGIT_TOL)
    for k in jc:
        _close(tc[k], jc[k])
    cur = np.int32([3, 5])
    jd, jc2 = JM.decode_step(jcfg, jp, jnp.asarray(cur), jc)
    td, tc2 = TM.decode_step(tcfg, tp, torch.from_numpy(cur).long(), tc,
                             impl="paged")
    _close(td, jd, LOGIT_TOL)
    for k in jc2:
        _close(tc2[k], jc2[k])


def test_a_windowed_dense_config_trains_like_jax():
    """A sliding window on the dense family trains (the hybrid family
    trains too: ``test_check_supported_serves_and_refuses_training``):
    the loss and a weight's gradient against JAX's ``train_loss``."""
    jcfg, tcfg = reduced_pair("tinyllama-1.1b", window=8)
    jp, tp = params_pair(jcfg)
    toks = _toks(jcfg, 2, 24, seed=25)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jl, jg = jax.value_and_grad(lambda p: JM.train_loss(jcfg, p, batch))(jp)
    wq = tp["layers"]["attn"]["wq"].requires_grad_(True)
    t = torch.from_numpy(toks).long()
    tl = TM.train_loss(tcfg, tp, {"tokens": t, "labels": t})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _close(wq.grad, jg["layers"]["attn"]["wq"])
