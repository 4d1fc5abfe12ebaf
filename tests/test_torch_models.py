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


@pytest.mark.parametrize("over,item", [
    (dict(num_experts=4, experts_per_token=2, moe_d_ff=32), "A7"),
    (dict(window=32), "A8"),
    (dict(family="ssm"), "A9"),
    (dict(family="vlm"), "A10"),
])
def test_unported_families_raise(over, item):
    _, tcfg = reduced_pair()
    with pytest.raises(ValueError, match=item):
        TM.check_supported(dataclasses.replace(tcfg, **over))
