"""The port's RWKV6 model (``repro_torch.models.rwkv`` and the ``ssm``
family of ``models.model``) against ``repro.models`` on the CPU, at the
reduced ``rwkv6-7b`` width in fp32 with the JAX weights (taken through
``params_from_jax``).  Inputs are made with numpy from stated seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import rwkv as JR
from repro_torch.models import model as TM
from repro_torch.models import rwkv as TR
from repro_torch.serving import serve_step as SS
from repro_torch.training import make_loss_fn, value_and_grad

from _torch_parity import np_of, params_pair, reduced_pair, to_torch

torch.set_num_threads(2)

#: fp32 layers, logits and every cache leaf: XLA and torch sum in other
#: orders, the closed chunked WKV6 form divides by cumulative decays
TOL = dict(rtol=1e-5, atol=1e-5)
#: tests/test_models.py:216-230: a full prefill against prefill + decode
CONTINUITY_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = reduced_pair("rwkv6-7b")
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np_of(got), np_of(want), **tol)


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S)) \
        .astype(np.int32)


# --------------------------------------------------------------------- #
# params and cache
# --------------------------------------------------------------------- #

def test_params_from_jax_takes_the_flat_ssm_tree(models):
    jcfg, _, jp, tp = models
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert set(tl) == set(jl) and len(tl) == 20
    for name, t in tl.items():
        np.testing.assert_array_equal(t.numpy(), jl[name])
        if name.startswith("layers."):
            assert t.shape[0] == jcfg.num_layers, name


def test_params_from_jax_keeps_fp32_leaves_in_a_bf16_model():
    jcfg, _ = reduced_pair("rwkv6-7b", dtype="bfloat16")
    jp, tp = params_pair(jcfg)
    lay = tp["layers"]
    for name in ("mu", "decay_base", "bonus", "cm_mu"):
        assert lay[name].dtype == torch.float32, name
        np.testing.assert_array_equal(lay[name].numpy(),
                                      np.asarray(jp["layers"][name]))
    for name in ("wr", "cm_k", "ln_x", "ln1"):
        assert lay[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(
            lay[name].float().numpy(),
            np.asarray(jp["layers"][name]).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_structure_matches_jax(dtype):
    jcfg, tcfg = reduced_pair("rwkv6-7b", dtype=dtype)
    jl = dict(_leaves(jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))))
    tl = dict(_leaves(TM.init_params(tcfg, 0, device="cpu")))
    assert {k: (v.shape, str(v.dtype)) for k, v in jl.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tl.items()}
    # linspace(-6, -1): the two libraries round its steps alike to 1 ulp
    np.testing.assert_allclose(tl["layers.decay_base"].numpy(),
                               jl["layers.decay_base"], rtol=1e-6, atol=1e-6)
    mu = tl["layers.mu"].numpy()
    assert 0.25 <= mu.min() and mu.max() <= 0.75
    again = dict(_leaves(TM.init_params(tcfg, 0, device="cpu")))
    for k in tl:                               # seeded: reproducible
        assert torch.equal(tl[k], again[k]), k


def test_init_cache_matches(models):
    jcfg, tcfg, _, _ = models
    jc = JM.init_cache(jcfg, 3, 24)
    tc = TM.init_cache(tcfg, 3, 24, device="cpu")
    assert set(tc) == set(jc) == {"index", "S", "x_tm", "x_cm"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).replace("torch.", "") == str(jc[k].dtype), k
        np.testing.assert_array_equal(np_of(tc[k]), np.asarray(jc[k]))


# --------------------------------------------------------------------- #
# layer functions
# --------------------------------------------------------------------- #

def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]),
            TM.unstack_layers(tp)[0])


def _state(seed, cfg, B):
    rs = np.random.RandomState(seed)
    H, D, d = cfg.ssm_heads, cfg.ssm_state, cfg.d_model
    return {"S": rs.randn(B, H, D, D).astype(np.float32) * 0.5,
            "x_tm": rs.randn(B, 1, d).astype(np.float32),
            "x_cm": rs.randn(B, 1, d).astype(np.float32)}


@pytest.mark.parametrize("S,length", [(16, None), (40, [40, 17, 0]),
                                      (8, [3, 8, 1])])
def test_time_mix_full_matches(models, S, length):
    jcfg, tcfg, jp, tp = models
    jl, tl = _layer0(jp, tp)
    B = 3
    x = np.random.RandomState(1).randn(B, S, jcfg.d_model).astype(np.float32)
    st = _state(2, jcfg, B)
    ln = None if length is None else np.asarray(length, np.int32)
    jy, jst = JR.rwkv_time_mix_full(
        jl, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()},
        length=None if ln is None else jnp.asarray(ln))
    ty, tst = TR.rwkv_time_mix_full(
        tl, tcfg, to_torch(x), {k: to_torch(v) for k, v in st.items()},
        length=None if ln is None else to_torch(ln))
    _close(ty, jy)
    for k in ("S", "x_tm", "x_cm"):
        _close(tst[k], jst[k])
    if ln is not None:           # a length-0 row keeps its state exactly
        for b in np.flatnonzero(ln == 0):
            assert torch.equal(tst["S"][b], to_torch(st["S"][b]))
            assert torch.equal(tst["x_tm"][b], to_torch(st["x_tm"][b]))


def test_time_mix_decode_and_channel_mix_match(models):
    jcfg, tcfg, jp, tp = models
    jl, tl = _layer0(jp, tp)
    B = 2
    rs = np.random.RandomState(3)
    x = rs.randn(B, 1, jcfg.d_model).astype(np.float32)
    st = _state(4, jcfg, B)
    jy, jst = JR.rwkv_time_mix_decode(
        jl, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = TR.rwkv_time_mix_decode(
        tl, tcfg, to_torch(x), {k: to_torch(v) for k, v in st.items()})
    _close(ty, jy)
    for k in ("S", "x_tm", "x_cm"):
        _close(tst[k], jst[k])
    xs = rs.randn(B, 6, jcfg.d_model).astype(np.float32)
    ln = np.asarray([4, 0], np.int32)
    jo, jprev = JR.rwkv_channel_mix(jl, jcfg, jnp.asarray(xs),
                                    jnp.asarray(st["x_cm"]),
                                    length=jnp.asarray(ln))
    to, tprev = TR.rwkv_channel_mix(tl, tcfg, to_torch(xs),
                                    to_torch(st["x_cm"]), length=to_torch(ln))
    _close(to, jo)
    _close(tprev, jprev)


def test_token_shift_and_last_valid_match():
    rs = np.random.RandomState(5)
    x = rs.randn(3, 5, 4).astype(np.float32)
    prev = rs.randn(3, 1, 4).astype(np.float32)
    np.testing.assert_array_equal(
        TR._token_shift(to_torch(x), to_torch(prev)).numpy(),
        np.asarray(JR._token_shift(jnp.asarray(x), jnp.asarray(prev))))
    for ln in (None, np.asarray([5, 0, 2], np.int32)):
        want = JR._last_valid(jnp.asarray(x), None if ln is None
                              else jnp.asarray(ln), jnp.asarray(prev))
        got = TR._last_valid(to_torch(x), None if ln is None
                             else to_torch(ln), to_torch(prev))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_rwkv_state_matches(models):
    jcfg, tcfg, _, _ = models
    js = JR.init_rwkv_state(jcfg, 2)
    ts = TR.init_rwkv_state(tcfg, 2, device="cpu")
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, k
        assert not ts[k].any()


# --------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------- #

def _jax_and_torch_prefill(models, toks):
    jcfg, tcfg, jp, tp = models
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        cache_len=64)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": to_torch(toks).long()},
                        cache_len=64)
    return jl, jc, tl, tc


def test_prefill_logits_and_every_cache_leaf_match(models):
    toks = _tokens(6, 2, 40, models[0].vocab_size)
    jl, jc, tl, tc = _jax_and_torch_prefill(models, toks)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k])


def test_decode_step_matches(models):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(7, 2, 21, jcfg.vocab_size)
    jl, jc, tl, tc = _jax_and_torch_prefill(models, toks)
    for step in range(3):
        nxt = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size], -1) \
            .astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = TM.decode_step(tcfg, tp, to_torch(nxt), tc)
        _close(tl, jl)
        for k in jc:
            _close(tc[k], jc[k])


def test_decode_continues_the_prefill_state(models):
    """tests/test_models.py:216-230 in the port: prefill of 17 tokens ==
    prefill of 16 then one decode step."""
    _, tcfg, _, tp = models
    toks = to_torch(_tokens(8, 1, 16, tcfg.vocab_size)).long()
    t17 = torch.cat([toks, toks[:, :1]], dim=1)
    lf, _ = TM.prefill(tcfg, tp, {"tokens": t17}, cache_len=32)
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks}, cache_len=32)
    ld, _ = TM.decode_step(tcfg, tp, toks[:, 0], cache)
    torch.testing.assert_close(ld, lf, **CONTINUITY_TOL)


def test_padded_prefill_chunk_matches(models):
    """A bucketed chunk round against a prefilled cache: padded rows and
    a length-0 row (inert: its state is untouched)."""
    jcfg, tcfg, jp, tp = models
    toks = _tokens(9, 3, 24, jcfg.vocab_size)
    _, jc, _, tc = _jax_and_torch_prefill(models, toks)
    chunk = _tokens(10, 3, 16, jcfg.vocab_size)
    ln = np.asarray([16, 5, 0], np.int32)
    jl, jc2 = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc,
                               length=jnp.asarray(ln))
    tl, tc2 = TM.prefill_chunk(tcfg, tp, to_torch(chunk), tc,
                               length=to_torch(ln))
    _close(tl[:2], np.asarray(jl)[:2])          # row 2's logits: garbage
    assert set(tc2) == set(jc2)
    for k in jc2:
        _close(tc2[k], jc2[k])
    np.testing.assert_array_equal(tc2["index"].numpy(), [40, 29, 24])
    for k in ("S", "x_tm", "x_cm"):
        assert torch.equal(tc2[k][:, 2], tc[k][:, 2]), k
    # unpadded, too, through build_prefill_chunk_fn
    jl3, jc3 = JM.prefill_chunk(jcfg, jp, jnp.asarray(chunk), jc)
    tl3, tc3 = SS.build_prefill_chunk_fn(tcfg)(tp, to_torch(chunk), tc, None)
    _close(tl3, jl3)
    for k in jc3:
        _close(tc3[k], jc3[k])


def test_train_loss_on_rwkv_raises_naming_a9(models):
    """A9 is ported: RWKV6 trains through the closed chunked form (JAX's
    training arithmetic), and the loss and every gradient leaf equal
    JAX's ``train_loss``'s (fp32, leaf-relative 1e-4)."""
    jcfg, tcfg, jp, tp = models
    toks = _tokens(11, 2, 16, tcfg.vocab_size)
    jl, jg = jax.value_and_grad(lambda p: JM.train_loss(
        jcfg, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}))(
        jp)
    t = to_torch(toks).long()
    tl, tg = value_and_grad(make_loss_fn(tcfg))(tp, {"tokens": t,
                                                     "labels": t})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jg)))
    for name, g in _leaves(tg):
        want = jleaves[name]
        assert np.abs(np_of(g) - want).max() <= 1e-4 * np.abs(want).max(), \
            name


def test_prefill_chunk_on_the_dense_family_raises_naming_a5():
    """The dense family's chunk step is ported (ROADMAP A5d,
    ``tests/test_torch_planes.py``), under a sliding window too (A8,
    ``tests/test_torch_hybrid.py``), where, as in JAX, it refuses a ring
    that is not exactly window-sized."""
    _, tcfg = reduced_pair()
    tp = TM.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="exactly window-sized"):
        TM.prefill_chunk(dataclasses.replace(tcfg, window=4), tp,
                         torch.zeros((1, 4), dtype=torch.long),
                         TM.init_cache(tcfg, 1, 8, device="cpu"))
