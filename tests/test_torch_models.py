"""The port's dense model layer against ``repro.models`` on the CPU:
the params bridge, the shared layers, and prefill/decode logits and
caches, at the reduced TinyLlama width in fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import common as JC
from repro.models import model as JM
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import model as TM

from _torch_parity import np_of, params_pair, reduced_pair, to_torch

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
# prefill/decode logits: XLA and torch sum in different orders over two
# layers plus the head, so fp32 agreement is to ~1e-5 relative
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = reduced_pair()
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_params_from_jax_keeps_leaves_and_layer_axis(models):
    jcfg, _, jp, tp = models
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert len(tl) == 12 and set(tl) == set(jl)
    for name, t in tl.items():
        assert tuple(t.shape) == jl[name].shape, name
        np.testing.assert_array_equal(t.numpy(), jl[name])
        if name.startswith("layers."):
            assert t.shape[0] == jcfg.num_layers, name
    # (in, out) layout: x @ W
    assert tuple(tp["layers"]["attn"]["wq"].shape[1:]) == \
        (jcfg.d_model, jcfg.q_dim)


def test_params_from_jax_bfloat16_bits():
    jcfg, _ = reduced_pair(dtype="bfloat16")
    jp, tp = params_pair(jcfg)
    want = np.asarray(jp["embed"]).astype(np.float32)
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(), want)


def test_init_params_structure_matches_jax():
    jcfg, tcfg = reduced_pair()
    jl = dict(_leaves(jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))))
    tl = dict(_leaves(TM.init_params(tcfg, 0, device="cpu")))
    assert {k: v.shape for k, v in jl.items()} == \
        {k: tuple(v.shape) for k, v in tl.items()}
    again = dict(_leaves(TM.init_params(tcfg, 0, device="cpu")))
    for k in tl:                               # seeded: reproducible
        assert torch.equal(tl[k], again[k]), k


def test_rms_norm_matches():
    rs = np.random.RandomState(0)
    x, s = rs.randn(3, 5, 64).astype(np.float32), \
        rs.randn(64).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        TC.rms_norm(*to_torch(x, s), 1e-5).numpy(),
        np.asarray(JC.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5)), **TOL)


def test_apply_rope_matches():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 4, 16).astype(np.float32)
    pos = rs.randint(0, 300, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        TC.apply_rope(*to_torch(x, pos), 10000.0).numpy(),
        np.asarray(JC.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 10000.0)), **TOL)


def test_gated_mlp_matches():
    rs = np.random.RandomState(2)
    p = {k: rs.randn(*s).astype(np.float32) * 0.2 for k, s in
         (("wi_gate", (64, 128)), ("wi_up", (64, 128)), ("wo", (128, 64)))}
    x = rs.randn(2, 3, 64).astype(np.float32)
    got = TC.gated_mlp({k: to_torch(v) for k, v in p.items()}, to_torch(x))
    want = JC.gated_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_matches(models, qk_norm):
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, qk_norm=qk_norm)
    tcfg = dataclasses.replace(tcfg, qk_norm=qk_norm)
    rs = np.random.RandomState(3)
    lpj = {k: np.asarray(v[0]) for k, v in jp["layers"]["attn"].items()}
    if qk_norm:
        lpj["q_norm"] = rs.randn(jcfg.head_dim_).astype(np.float32) * 0.1
        lpj["k_norm"] = rs.randn(jcfg.head_dim_).astype(np.float32) * 0.1
    x = rs.randn(2, 5, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32) + 3, (2, 5)).copy()
    got = TA._project_qkv({k: to_torch(v) for k, v in lpj.items()}, tcfg,
                          *to_torch(x, pos))
    want = JA._project_qkv({k: jnp.asarray(v) for k, v in lpj.items()},
                           jcfg, jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_prefill_and_decode_logits_match(models):
    jcfg, tcfg, jp, tp = models
    rs = np.random.RandomState(4)
    toks = rs.randint(0, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        cache_len=32, moe_impl="dense")
    tl, tc = TM.prefill(tcfg, tp, {"tokens": to_torch(toks).long()},
                        cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tc["index"].numpy(),
                                  np.asarray(jc["index"]))
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **LOGIT_TOL)
    nxt = rs.randint(0, jcfg.vocab_size, size=(2,)).astype(np.int32)
    for _ in range(3):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc,
                                moe_impl="dense")
        tl, tc = TM.decode_step(tcfg, tp, to_torch(nxt).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_array_equal(tc["index"].numpy(),
                                      np.asarray(jc["index"]))
        nxt = np.asarray(jnp.argmax(jl[:, :jcfg.vocab_size], axis=-1),
                         np.int32)


def test_init_cache_matches(models):
    jcfg, tcfg, _, _ = models
    jc = JM.init_cache(jcfg, 3, 24)
    tc = TM.init_cache(tcfg, 3, 24, device="cpu")
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_array_equal(np_of(tc[k]), np.asarray(jc[k]))


#: the ROADMAP items of this list that are ported: their families train
PORTED = ("A7", "A8-ii", "A9", "A10")


@pytest.mark.parametrize("over,item", [
    (dict(num_experts=4, experts_per_token=2, moe_d_ff=32), "A7"),
    (dict(family="hybrid", window=32, ssm_state=4, ssm_heads=4), "A8-ii"),
    (dict(family="ssm"), "A9"),
    (dict(family="vlm"), "A10"),
    (dict(family="audio", frontend="frames"), "A10"),
])
def test_unported_families_raise(over, item):
    """Every item is ported: MoE (A7), the hybrid family (A8-ii), RWKV6
    (A9) and the VLM and audio families (A10) all train
    (``tests/test_torch_train_families.py`` holds them against JAX)."""
    _, tcfg = reduced_pair()
    cfg = dataclasses.replace(tcfg, **over)
    if item in PORTED:
        TM.check_supported(cfg, train=True)
        return
    with pytest.raises(ValueError, match=item):
        TM.check_supported(cfg, train=True)


# --------------------------------------------------------------------- #
# the full-sequence path: prefill on the flash kernel, generate_reference
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_prefill_impl_and_length_match_jax(models, impl):
    jcfg, tcfg, jp, tp = models
    rs = np.random.RandomState(6)
    toks = rs.randint(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    length = np.array([13, 9], np.int32)
    batch = {"tokens": toks, "length": length}
    jl, jc = JM.prefill(jcfg, jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()},
                        cache_len=24, impl=impl, moe_impl="dense")
    tl, tc = TM.prefill(tcfg, tp, {"tokens": to_torch(toks).long(),
                                   "length": to_torch(length)},
                        cache_len=24, impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["index"].dtype == torch.int32
    np.testing.assert_array_equal(tc["index"].numpy(), length)
    np.testing.assert_array_equal(tc["index"].numpy(),
                                  np.asarray(jc["index"]))
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **LOGIT_TOL)


def test_prefill_flash_equals_reference(models):
    _, tcfg, _, tp = models
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, tcfg.vocab_size, size=(3, 17))).long()
    ref = TM.prefill(tcfg, tp, {"tokens": toks}, cache_len=20)
    fl = TM.prefill(tcfg, tp, {"tokens": toks}, cache_len=20, impl="flash")
    torch.testing.assert_close(fl[0], ref[0], **TOL)
    for k in ("k", "v", "index"):
        torch.testing.assert_close(fl[1][k], ref[1][k], **TOL)


def test_generate_reference_flash_tokens_match_jax(models):
    from repro.serving.engine import generate_reference as jgen
    from repro_torch.serving import generate_reference as tgen
    jcfg, tcfg, jp, tp = models
    rs = np.random.RandomState(8)
    for n in (5, 12):
        prompt = rs.randint(0, jcfg.vocab_size, size=n).tolist()
        want = jgen(jcfg, jp, prompt, 6, cache_len=32, impl="flash")
        assert tgen(tcfg, tp, prompt, 6, cache_len=32, impl="flash",
                    device="cpu") == want
        assert tgen(tcfg, tp, prompt, 6, cache_len=32,
                    device="cpu") == want


def test_train_loss_and_its_attention_impls_match_jax(models):
    jcfg, tcfg, jp, tp = models
    rs = np.random.RandomState(9)
    toks = rs.randint(0, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    labels = rs.randint(-1, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    want = float(JM.train_loss(jcfg, jp, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)}))
    batch = {"tokens": to_torch(toks).long(), "labels": to_torch(labels)}
    for impl in ("reference", "flash"):
        for remat in (True, False):
            with torch.no_grad():
                got = TM.train_loss(tcfg, tp, batch, impl=impl, remat=remat)
            np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_softmax_cross_entropy_matches_jax():
    rs = np.random.RandomState(10)
    logits = rs.randn(3, 5, 40).astype(np.float32) * 3
    labels = rs.randint(-2, 33, size=(3, 5)).astype(np.int32)
    want = JC.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    33)
    got = TC.softmax_cross_entropy(*to_torch(logits, labels), 33)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = TC.softmax_cross_entropy(to_torch(logits),
                                    torch.full((3, 5), -1), 33)
    assert float(none) == 0.0


@pytest.mark.parametrize("kw", [dict(), dict(window=4), dict(prefix_len=3),
                                dict(window=2, prefix_len=5)])
def test_causal_mask_options_match_jax(kw):
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    want = JC.causal_mask(jnp.asarray(pos), jnp.asarray(pos), **kw)
    got = TC.causal_mask(to_torch(pos), to_torch(pos), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn,over,item", [
    ("decode_step", {}, "set_mesh"),
    ("decode_step_deferred", {}, "set_mesh"),
    ("decode_step", dict(window=8), "set_mesh"),
])
def test_unported_decode_impls_raise(models, fn, over, item):
    """``impl="seqsharded"`` (a sequence-sharded cache) needs a mesh: on
    both decode paths, over a sliding window's ring too, it raises JAX's
    ``set_mesh`` error when none is set (tests/test_torch_distributed.py
    runs it under one)."""
    _, tcfg, _, tp = models
    cache = TM.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match=item):
        getattr(TM, fn)(dataclasses.replace(tcfg, **over), tp,
                        torch.zeros((1,), dtype=torch.long), cache,
                        impl="seqsharded")


def test_attention_full_refuses_window_and_short_cache(models):
    """A sliding window serves: the windowed attention and its cropped
    ring against JAX's; full attention still refuses a cache shorter
    than the prompt (JAX would crop it silently)."""
    jcfg, tcfg, jp, tp = models
    lp = TM.unstack_layers(tp)[0]["attn"]
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    x = np.random.RandomState(30).randn(1, 6, tcfg.d_model) \
        .astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    jw, tw = (dataclasses.replace(c, window=4) for c in (jcfg, tcfg))
    jo, jc = JA.attention_full(jl, jw, jnp.asarray(x), jnp.asarray(pos),
                               cache_len=4)
    to, tc = TA.attention_full(lp, tw, torch.from_numpy(x),
                               torch.from_numpy(pos).long(), cache_len=4)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    with pytest.raises(ValueError, match="cache_len 4 < prompt length 6"):
        TA.attention_full(lp, tcfg, torch.from_numpy(x),
                          torch.from_numpy(pos).long(), cache_len=4)


def test_serve_step_builders(models):
    from repro_torch.serving import serve_step as SS
    _, tcfg, _, tp = models
    toks = torch.from_numpy(np.random.RandomState(11).randint(
        0, tcfg.vocab_size, size=(2, 7))).long()
    logits, cache = SS.build_prefill_fn(tcfg, cache_len=12,
                                        impl="flash")(tp, {"tokens": toks})
    want = TM.prefill(tcfg, tp, {"tokens": toks}, cache_len=12)
    torch.testing.assert_close(logits, want[0], **TOL)
    nxt = torch.argmax(logits, dim=-1)
    got = SS.build_decode_fn(tcfg)(tp, nxt, cache)
    torch.testing.assert_close(got[0], TM.decode_step(tcfg, tp, nxt,
                                                      cache)[0])
    loss = SS.build_train_fn(tcfg, remat=False)(
        tp, {"tokens": toks, "labels": toks})
    assert loss.ndim == 0 and torch.isfinite(loss)
    # the slot planes' chunk step and the deferred-append decode
    chunk = SS.build_prefill_chunk_fn(tcfg)(tp, toks, cache,
                                            torch.tensor([7, 3]))
    want = TM.prefill_chunk(tcfg, tp, toks, cache,
                            length=torch.tensor([7, 3]))
    torch.testing.assert_close(chunk[0], want[0])
    deferred = SS.build_decode_fn(tcfg, append="deferred")(tp, nxt, cache)
    torch.testing.assert_close(deferred[0], got[0], **TOL)
    with pytest.raises(ValueError, match="unknown decode append"):
        SS.build_decode_fn(tcfg, append="later")
