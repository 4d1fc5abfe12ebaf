"""The port's VLM and audio families (ROADMAP A10) against the JAX package
on the CPU, at the reduced configs in fp32: PaliGemma-3B (``vlm``: 4 q /
1 kv heads of 16, a GELU MLP, embeddings scaled by sqrt(d), 4 patch
embeddings projected in front of the text as a bidirectional prefix) and
MusicGen-medium (``audio``: 4 / 2 heads, sinusoidal positions at every
absolute position).

Model level: the config registry, the params tree (``patch_proj``) and
its bridge, ``sinusoidal_pos_emb``, ``_embed``, ``prefill`` with and
without the image prefix (both ``impl``s of the port held against JAX's
``impl="reference"``: JAX's Pallas kernel leaves its own oracle once the
prefix outgrows one query block, ROADMAP C), ``prefill_chunk`` over
uneven chunks with a padded row, ``decode_step`` and
``decode_step_deferred`` after an image prefix, ``train_loss`` and every
gradient (``patch_proj``'s included), ``generate_reference``; the
training batch (``launch.train.batch_at``).  Kernel level: the plain
versions of B1, B2 and B3 at head dim 256 with PaliGemma-3B's 8 query
heads over 1, against the JAX oracles (``ref.py``).

Tolerances: logits 1e-4 and caches 2e-5 (``tests/test_torch_models.py``:
XLA and torch sum in other orders); gradients 5e-4 relative
(``tests/test_torch_training.py``); the kernels' plain versions 2e-5
fp32, 2e-2 bf16 (``tests/test_kernels.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import batch_with_frontend as j_batch_with_frontend
from repro.kernels.flash_attention.ref import attention_reference
from repro.kernels.paged_attention import ref as JR
from repro.models import common as JC
from repro.models import model as JM
from repro.serving import generate_reference as j_reference
from repro_torch.configs import ASSIGNED_ARCHS as T_ARCHS
from repro_torch.configs import get_config as torch_get_config
from repro_torch.data import DataConfig
from repro_torch.kernels.flash_attention import ref as TFR
from repro_torch.kernels.paged_attention import ref as TR
from repro_torch.launch import train as T
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.serving import generate_reference as t_reference
from repro_torch.training import make_loss_fn, value_and_grad

from _torch_parity import np_of, params_pair, reduced_pair

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)
NAMES = ["paligemma-3b", "musicgen-medium"]
CACHE_LEN = 40


def ktol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    jcfg, tcfg = reduced_pair(request.param)
    jp, tp = params_pair(jcfg)
    return jcfg, tcfg, jp, tp


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


def _batch(cfg, B, S, seed, patches=True, labels=False):
    """numpy inputs: tokens (B, S), and a ``patch`` model's patch
    embeddings (B, P, d) when ``patches``."""
    rs = np.random.RandomState(seed)
    out = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if labels:
        out["labels"] = rs.randint(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if patches and cfg.frontend == "patch":
        out["patch_embeds"] = rs.randn(B, cfg.num_patches, cfg.d_model) \
            .astype(np.float32)
    return out


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v) for k, v in b.items()}


def _assert_cache(tc, jc, tol=TOL):
    assert set(tc) == set(jc)
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
    for k in jc:
        if k != "index":
            np.testing.assert_allclose(np_of(tc[k]), np_of(jc[k]), **tol,
                                       err_msg=k)


# --------------------------------------------------------------------- #
# configs, params, frontends
# --------------------------------------------------------------------- #

def test_every_assigned_arch_is_registered_as_in_jax():
    assert T_ARCHS == J_ARCHS and len(T_ARCHS) == 10
    for name in T_ARCHS:
        assert dataclasses.asdict(torch_get_config(name)) == \
            dataclasses.asdict(jax_get_config(name)), name


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(name, dtype):
    """The same leaves, shapes and dtypes as JAX's ``init_params``:
    ``patch_proj`` (d, d) on the ``patch`` model only."""
    jcfg, tcfg = reduced_pair(name, dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jl = dict(_named(jax.tree.map(np.asarray, jp)))
    tl = dict(_named(TM.init_params(tcfg, 0, device="cpu")))
    assert set(tl) == set(jl)
    assert ("patch_proj" in tl) == (tcfg.frontend == "patch")
    for k, t in tl.items():
        assert tuple(t.shape) == jl[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(jl[k].dtype), k


def test_params_from_jax_carries_patch_proj(models):
    jcfg, _, jp, tp = models
    if jcfg.frontend != "patch":
        assert "patch_proj" not in tp
        return
    np.testing.assert_array_equal(tp["patch_proj"].numpy(),
                                  np.asarray(jp["patch_proj"]))


def test_sinusoidal_pos_emb_matches_jax():
    """XLA's and torch's fp32 ``exp`` differ by one ulp on some of the
    frequencies (72 of MusicGen's 768), and a position p multiplies that
    into the angle: the angles differ by at most p * 2^-24 (a frequency
    is at most 1, its ulp at most 2^-24) plus each product's rounding to
    fp32 (half an ulp of an angle below p: p * 2^-24 each), so each
    element is held to 3 p 2^-24 plus 2e-7 for sin and cos."""
    pos = np.array([[0, 1, 7, 500], [3, 1023, 2048, 32767]], np.int32)
    for dim in (16, 1536):
        want = np.asarray(JC.sinusoidal_pos_emb(jnp.asarray(pos), dim))
        got = TC.sinusoidal_pos_emb(torch.from_numpy(pos), dim)
        assert got.dtype == torch.float32 and got.shape == want.shape
        bound = 3 * pos[..., None] * 2.0 ** -24 + 2e-7
        assert (np.abs(got.numpy() - want) <= bound).all(), dim


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("patches", [False, True])
def test_embed_matches_jax(name, dtype, patches):
    """``_embed`` at d = 2048, where sqrt(d) is not exact: the scale is
    rounded to the dtype before the product, as JAX casts it, so the bf16
    VLM embeddings are JAX's bit for bit (the sinusoids of the audio
    model are not: ``test_sinusoidal_pos_emb_matches_jax``); positions
    start mid-sequence."""
    jcfg, tcfg = reduced_pair(name, dtype=dtype, d_model=2048)
    jp, tp = params_pair(jcfg)
    b = _batch(jcfg, 2, 5, 1, patches=patches)
    pos = np.array([[9, 10, 11, 12, 13], [0, 1, 2, 3, 4]], np.int32)
    jx, jpre = JM._embed(jcfg, jp, jnp.asarray(b["tokens"]),
                         jnp.asarray(pos),
                         jnp.asarray(b["patch_embeds"]) if "patch_embeds"
                         in b else None)
    tx, tpre = TM._embed(tcfg, tp, torch.from_numpy(b["tokens"]).long(),
                         torch.from_numpy(pos),
                         torch.from_numpy(b["patch_embeds"]) if
                         "patch_embeds" in b else None)
    assert tpre == jpre == (tcfg.num_patches if "patch_embeds" in b else 0)
    assert tx.dtype == getattr(torch, dtype) and tuple(tx.shape) == jx.shape
    if dtype == "bfloat16" and tcfg.family == "vlm" and not tpre:
        np.testing.assert_array_equal(np_of(tx), np_of(jx))
    else:
        np.testing.assert_allclose(np_of(tx), np_of(jx), **ktol(dtype))


@pytest.mark.parametrize("name", NAMES)
def test_frontends_serve_and_train(name):
    _, tcfg = reduced_pair(name)
    TM.check_supported(tcfg)
    TM.check_supported(tcfg, train=True)
    with pytest.raises(ValueError, match="unknown family"):
        TM.check_supported(dataclasses.replace(tcfg, family="video"))


# --------------------------------------------------------------------- #
# prefill, chunks, decode
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("patches", [False, True])
def test_prefill_matches_jax(models, impl, patches):
    """Logits, cache and index (``length + prefix``) against JAX's
    reference prefill, with and without the image prefix."""
    jcfg, tcfg, jp, tp = models
    b = _batch(jcfg, 2, 13, 2, patches=patches)
    b["length"] = np.array([13, 9], np.int32)
    jl, jc = JM.prefill(jcfg, jp, _jax_batch(b), cache_len=CACHE_LEN)
    tl, tc = TM.prefill(tcfg, tp, _torch_batch(b), cache_len=CACHE_LEN,
                        impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache(tc, jc)
    pre = jcfg.num_patches if "patch_embeds" in b else 0
    assert tc["index"].tolist() == [13 + pre, 9 + pre]


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_chunk_uneven_chunks_match_jax(models, padded):
    """Chunks of 5, 3 and 7 tokens from an empty cache (``padded``: a
    bucket of 8 with each row's real length, one row of length 0 in the
    second chunk); logits and cache after every chunk."""
    jcfg, tcfg, jp, tp = models
    rs = np.random.RandomState(3)
    jc = JM.init_cache(jcfg, 2, CACHE_LEN)
    tc = TM.init_cache(tcfg, 2, CACHE_LEN, device="cpu")
    for n, lens in ((5, [5, 4]), (3, [3, 0]), (7, [7, 6])):
        c = 8 if padded else n
        toks = rs.randint(0, jcfg.vocab_size, (2, c)).astype(np.int32)
        kw = {}
        if padded:
            kw = dict(length=np.array(lens, np.int32))
        jl, jc = JM.prefill_chunk(jcfg, jp, jnp.asarray(toks), jc,
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
        tl, tc = TM.prefill_chunk(tcfg, tp, torch.from_numpy(toks).long(), tc,
                                  **{k: torch.from_numpy(v)
                                     for k, v in kw.items()})
        live = [i for i, ln in enumerate(lens) if ln or not padded]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGIT_TOL)
        _assert_cache(tc, jc)


@pytest.mark.parametrize("deferred", [False, True])
def test_decode_steps_match_jax(models, deferred):
    """Three greedy decode steps (``decode_step`` or
    ``decode_step_deferred``) after a prefill with the image prefix:
    logits and cache every step."""
    jcfg, tcfg, jp, tp = models
    b = _batch(jcfg, 2, 9, 4)
    jl, jc = JM.prefill(jcfg, jp, _jax_batch(b), cache_len=CACHE_LEN)
    tl, tc = TM.prefill(tcfg, tp, _torch_batch(b), cache_len=CACHE_LEN)
    jstep = JM.decode_step_deferred if deferred else JM.decode_step
    tstep = TM.decode_step_deferred if deferred else TM.decode_step
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, :jcfg.vocab_size], -1), np.int32)
        jl, jc = jstep(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tstep(tcfg, tp, torch.from_numpy(nxt).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_cache(tc, jc)


def test_generate_reference_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    prompt = np.random.RandomState(5).randint(0, jcfg.vocab_size, 11).tolist()
    want = j_reference(jcfg, jp, prompt, 6, cache_len=CACHE_LEN)
    for impl in ("reference", "flash"):
        assert t_reference(tcfg, tp, prompt, 6, cache_len=CACHE_LEN,
                           impl=impl, device="cpu") == want, impl


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #

def test_train_loss_and_grads_match_jax(models):
    """``train_loss`` (PaliGemma: patch embeddings in front, cropped
    before the head) and the gradient of every leaf, ``patch_proj``'s
    included."""
    jcfg, tcfg, jp, tp = models
    b = _batch(jcfg, 3, 10, 6, labels=True)
    b["labels"][0, :3] = -1                      # masked labels
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(jcfg, p, _jax_batch(b)))(jp)
    loss, grads = value_and_grad(make_loss_fn(tcfg))(tp, _torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = dict(_named(jax.tree.map(np.asarray, jgrads)))
    tg = dict(_named(grads))
    assert set(tg) == set(jg)
    assert ("patch_proj" in tg) == (jcfg.frontend == "patch")
    for name, g in tg.items():
        assert float(np.abs(jg[name]).max()) > 0 or name.startswith("ln"), \
            name
        np.testing.assert_allclose(g.numpy(), jg[name], **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_batch_at_keeps_tokens_int64_and_patch_embeds_float(name):
    """The trainer's batch: the token leaves int64, a ``patch`` model's
    patch embeddings float32 and equal to ``batch_with_frontend``'s (and
    so to the JAX package's)."""
    _, tcfg = reduced_pair(name)
    kw = dict(vocab_size=tcfg.vocab_size, seq_len=8, global_batch=2)
    got = T.batch_at(tcfg, DataConfig(**kw), 3, "cpu")
    want = j_batch_with_frontend(jax_get_config(name).reduced(),
                                 JDataConfig(**kw), 3)
    assert set(got) == set(want)
    assert ("patch_embeds" in got) == (tcfg.frontend == "patch")
    for k, v in want.items():
        assert got[k].dtype == (torch.float32 if k == "patch_embeds"
                                else torch.long), k
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_batch_at_of_a_patch_frontend_keeps_float_embeddings():
    """Any ``patch`` config (here the dense one with the stub frontend):
    ``batch_at`` once cast every leaf to int64, truncating the N(0, 1)
    patch embeddings toward zero (two thirds of them to 0)."""
    _, tcfg = reduced_pair("tinyllama-1.1b", frontend="patch",
                           num_patches=4)
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=8, global_batch=2)
    got = T.batch_at(tcfg, dc, 3, "cpu")["patch_embeds"]
    want = j_batch_with_frontend(tcfg, JDataConfig(**dataclasses.asdict(dc)),
                                 3)["patch_embeds"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_trainer_cli_trains_the_frontends(name):
    hist = T.train(T.parse_args(["--device", "cpu", "--arch", name,
                                 "--steps", "3", "--batch", "2", "--seq",
                                 "8", "--layers", "1"]))
    assert len(hist) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)


# --------------------------------------------------------------------- #
# the kernels' plain versions at head dim 256 (PaliGemma's 8 over 1)
# --------------------------------------------------------------------- #

H, HKV, D = 8, 1, 256


def _cast(a, dtype):
    return (jnp.asarray(a, dtype=jnp.dtype(dtype)),
            torch.from_numpy(np.array(a)).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("span", [None, 64])
def test_decode_plain_d256_matches_jax_oracle(dtype, span):
    """B1's plain version (``span``: its split-and-merge model) at
    contexts 1, on and across a 64-key split and the table's width."""
    rs = np.random.RandomState(7)
    B, page, npages = 5, 16, 8
    P = B * npages + 3
    q = rs.randn(B, H, D).astype(np.float32)
    kp = rs.randn(P, page, HKV, D).astype(np.float32)
    vp = rs.randn(P, page, HKV, D).astype(np.float32)
    bt = rs.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    ctx = np.array([1, 64, 65, 100, 128], np.int32)
    j = [_cast(a, dtype) for a in (q, kp, vp)]
    want = JR.paged_decode_reference(*[x[0] for x in j], jnp.asarray(bt),
                                     jnp.asarray(ctx))
    args = [x[1] for x in j] + [torch.from_numpy(bt), torch.from_numpy(ctx)]
    got = (TR.paged_decode_reference(*args) if span is None
           else TR.paged_decode_split_model(*args, span=span))
    np.testing.assert_allclose(np_of(got), np_of(want), **ktol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [8, 64])
def test_prefill_plain_d256_matches_jax_oracle(dtype, page):
    """B2's plain version: starts off the 64-key tile, a padded row and a
    length-0 row; outputs on real rows, and the pools bit for bit."""
    rs = np.random.RandomState(8)
    B, c = 3, 12
    starts = np.array([0, 37, 70], np.int32)
    lengths = np.array([12, 5, 0], np.int32)
    maxp = -(-(70 + c) // page)
    P = B * maxp + 2
    arrays = [rs.randn(B, c, H, D), rs.randn(B, c, HKV, D),
              rs.randn(B, c, HKV, D), rs.randn(P, page, HKV, D),
              rs.randn(P, page, HKV, D)]
    bt = rs.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    j = [_cast(a.astype(np.float32), dtype) for a in arrays]
    want = JR.paged_prefill_reference(*[x[0] for x in j], jnp.asarray(bt),
                                      jnp.asarray(starts),
                                      jnp.asarray(lengths))
    tq, tk, tv, tkp, tvp = [x[1] for x in j]
    out = TR.paged_prefill_reference(tq, tk, tv, tkp, tvp,
                                     torch.from_numpy(bt),
                                     torch.from_numpy(starts),
                                     torch.from_numpy(lengths))
    valid = np.arange(c)[None, :] < lengths[:, None]
    np.testing.assert_allclose(np_of(out)[valid], np_of(want[0])[valid],
                               **ktol(dtype))
    np.testing.assert_array_equal(np_of(tkp), np_of(want[1]))
    np.testing.assert_array_equal(np_of(tvp), np_of(want[2]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,prefix_len", [(77, 0), (150, 100), (300, 256)])
def test_flash_plain_d256_matches_jax_oracle(dtype, S, prefix_len):
    """B3's plain version, causal, with the bidirectional prefix."""
    rs = np.random.RandomState(9)
    arrays = [rs.randn(1, S, H, D), rs.randn(1, S, HKV, D),
              rs.randn(1, S, HKV, D)]
    j = [_cast(a.astype(np.float32), dtype) for a in arrays]
    want = attention_reference(*[x[0] for x in j], prefix_len=prefix_len)
    got = TFR.attention_reference(*[x[1] for x in j], prefix_len=prefix_len)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(np_of(got), np_of(want), **ktol(dtype))
