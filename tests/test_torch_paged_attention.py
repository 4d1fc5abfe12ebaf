"""The port's paged attention: plain PyTorch versions against the JAX
oracles (``repro.kernels.paged_attention.ref``) over the sweeps of
``tests/test_kernels.py`` and ``tests/test_paged_prefill_kernel.py``,
one small shape each against the Pallas kernels in interpret mode, and
the device dispatch.  The CUDA kernels themselves are held against these
plain versions on a card by ``test_torch_cuda_kernels.py``.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX oracles return new pools; the port updates them in place, so each
port call gets its own copy of the input pools."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ref as JR
from repro.kernels.paged_attention.ops import (paged_decode_attention,
                                               paged_prefill_attention)
from repro_torch.kernels.paged_attention import ops as TO
from repro_torch.kernels.paged_attention import paged_attention as TK
from repro_torch.kernels.paged_attention import ref as TR

from _torch_parity import np_of

torch.set_num_threads(2)


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _cast(a, dtype):
    """numpy float32 -> (jax array, torch tensor) of ``dtype``."""
    return (jnp.asarray(a, dtype=jnp.dtype(dtype)),
            torch.from_numpy(np.array(a)).to(getattr(torch, dtype)))


# --------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------- #

def _decode_inputs(B, H, Hkv, D, page, npages, seed=0, ctx=None):
    rs = np.random.RandomState(seed)
    P = B * npages + 3                       # spare pages in the pool
    q = rs.randn(B, H, D).astype(np.float32)
    kp = rs.randn(P, page, Hkv, D).astype(np.float32)
    vp = rs.randn(P, page, Hkv, D).astype(np.float32)
    bt = rs.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    if ctx is None:
        ctx = rs.randint(1, page * npages + 1, size=(B,))
    return q, kp, vp, bt, np.asarray(ctx, np.int32)


@pytest.mark.parametrize("B,H,Hkv,D,page,npages", [
    (2, 8, 2, 64, 16, 4),
    (4, 4, 4, 64, 32, 2),
    (1, 8, 1, 128, 64, 3),
    (8, 32, 4, 64, 16, 32),          # TinyLlama's main-path decode shape
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_oracle(B, H, Hkv, D, page, npages, dtype):
    q, kp, vp, bt, ctx = _decode_inputs(B, H, Hkv, D, page, npages)
    jq, tq = _cast(q, dtype)
    jk, tk = _cast(kp, dtype)
    jv, tv = _cast(vp, dtype)
    want = JR.paged_decode_reference(jq, jk, jv, jnp.asarray(bt),
                                     jnp.asarray(ctx))
    got = TR.paged_decode_reference(tq, tk, tv, torch.from_numpy(bt),
                                    torch.from_numpy(ctx))
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(np_of(got), np_of(want), **tol(dtype))


def test_decode_plain_short_context():
    """ctx=1: only the first position contributes."""
    q, kp, vp, bt, ctx = _decode_inputs(1, 4, 2, 64, 16, 4, ctx=[1])
    got = TR.paged_decode_reference(*map(torch.from_numpy,
                                         (q, kp, vp, bt, ctx)))
    want = JR.paged_decode_reference(*map(jnp.asarray, (q, kp, vp, bt, ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("f"))


def test_decode_plain_matches_pallas_interpret():
    q, kp, vp, bt, ctx = _decode_inputs(2, 4, 2, 64, 8, 2, seed=5)
    want = paged_decode_attention(*map(jnp.asarray, (q, kp, vp, bt, ctx)),
                                  interpret=True)
    got = TR.paged_decode_reference(*map(torch.from_numpy,
                                         (q, kp, vp, bt, ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("f"))


# --------------------------------------------------------------------- #
# decode: the CUDA kernel's split-and-merge, modelled in plain PyTorch
# --------------------------------------------------------------------- #

#: every span the kernel may pick up to a 4096-position table (it doubles
#: from 64 until the grid is small enough), and one wider than the table
SPANS = [64, 128, 256, 512, 1024, 2048, 4096]


def _split_edges(span, width):
    """Contexts on, one before and one past the split boundaries, ctx=1,
    the table's full width and a stale context beyond it."""
    ctx = [1, span - 1, span, span + 1, 2 * span - 1, 2 * span,
           2 * span + 1, width, 10_000]
    return [min(c, width) if c != 10_000 else c for c in ctx]


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("H,Hkv,D,page", [(8, 1, 64, 16), (6, 2, 128, 8),
                                          (2, 2, 64, 64)])
def test_decode_split_model_matches_jax_oracle(span, H, Hkv, D, page):
    """G = 8, 3 and 1; pages 16, 8 and 64; the table 2 * min(span, 256) +
    64 wide, so the larger spans cover it in one split and the smaller
    ones leave splits wholly past every short context."""
    width = 2 * min(span, 256) + 64
    ctx = _split_edges(min(span, width), width)
    q, kp, vp, bt, ctx = _decode_inputs(len(ctx), H, Hkv, D, page,
                                        width // page, seed=span, ctx=ctx)
    bt[-1] = 0                                # an inactive row, stale ctx
    want = JR.paged_decode_reference(*map(jnp.asarray, (q, kp, vp, bt, ctx)))
    got = TR.paged_decode_split_model(*map(torch.from_numpy,
                                           (q, kp, vp, bt, ctx)), span)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("f"))


@pytest.mark.parametrize("span", [64, 128, 256])
@pytest.mark.parametrize("H,Hkv,D,page,npages,ctx", [
    (4, 2, 64, 8, 20, [1, 65, 160]), (8, 1, 64, 16, 10, [1, 64, 129, 160]),
    (6, 2, 128, 8, 20, [63, 128, 160]), (3, 3, 64, 32, 9, [257, 31, 288])])
def test_decode_split_model_matches_pallas_interpret(span, H, Hkv, D, page,
                                                     npages, ctx):
    """The Pallas kernel in interpret mode, contexts across splits: G 2,
    8, 3 and 1, D 64 and 128, pages 8-32."""
    q, kp, vp, bt, ctx = _decode_inputs(len(ctx), H, Hkv, D, page, npages,
                                        seed=7, ctx=ctx)
    want = paged_decode_attention(*map(jnp.asarray, (q, kp, vp, bt, ctx)),
                                  interpret=True)
    got = TR.paged_decode_split_model(*map(torch.from_numpy,
                                           (q, kp, vp, bt, ctx)), span)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("f"))


@pytest.mark.parametrize("span", SPANS)
def test_decode_split_model_bf16_matches_jax_oracle(span):
    """bf16 inputs (the kernel's ``split_mma`` path): fp32 partials and
    merge, the output rounded to bf16, against the JAX oracle on the same
    rounded values at the bf16 tolerance."""
    width = 2 * min(span, 256) + 64
    ctx = _split_edges(min(span, width), width)
    q, kp, vp, bt, ctx = _decode_inputs(len(ctx), 16, 2, 64, 16,
                                        width // 16, seed=span + 1, ctx=ctx)
    q, kp, vp = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    got = TR.paged_decode_split_model(q, kp, vp, torch.from_numpy(bt),
                                      torch.from_numpy(ctx), span)
    assert got.dtype == torch.bfloat16
    want = JR.paged_decode_reference(*map(jnp.asarray, (
        q.float().numpy(), kp.float().numpy(), vp.float().numpy(), bt, ctx)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **tol("bfloat16"))


def test_decode_split_model_shared_prefix_pages():
    """Two rows that map the same prefix pages read them each."""
    q, kp, vp, bt, ctx = _decode_inputs(2, 8, 2, 64, 16, 12, seed=3,
                                        ctx=[150, 190])
    bt[1, :5] = bt[0, :5]
    want = JR.paged_decode_reference(*map(jnp.asarray, (q, kp, vp, bt, ctx)))
    for span in (64, 128, 256):
        got = TR.paged_decode_split_model(*map(torch.from_numpy,
                                               (q, kp, vp, bt, ctx)), span)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **tol("f"))


def test_decode_split_model_no_visible_key_gives_zeros():
    """ctx = 0: every split is empty and the row is zeros (the kernel's
    rule; the oracles, which mask with -1e30, average the values)."""
    q, kp, vp, bt, ctx = _decode_inputs(2, 4, 2, 64, 16, 8, ctx=[0, 70])
    got = TR.paged_decode_split_model(*map(torch.from_numpy,
                                           (q, kp, vp, bt, ctx)), 64)
    assert not got[0].abs().any() and got[1].abs().sum() > 0


def test_scatter_rows_sentinel_is_the_jax_drop():
    """Rows aimed at the sentinel page past the pool's real pages are the
    JAX scatter's out-of-range drop: the real pages match bit for bit."""
    rs = np.random.RandomState(6)
    P, pg, Hkv, D = 5, 8, 2, 16
    pool = rs.randn(P, pg, Hkv, D).astype(np.float32)
    rows = rs.randn(4, Hkv, D).astype(np.float32)
    dest = np.array([3, P * pg, 17, P * pg], np.int32)    # two dropped
    want = JR.scatter_rows(jnp.asarray(pool), jnp.asarray(dest),
                           jnp.asarray(rows))
    tpool = torch.from_numpy(np.concatenate(
        [pool, np.zeros((1, pg, Hkv, D), np.float32)]))  # + sentinel
    TR.scatter_rows(tpool, torch.from_numpy(dest), torch.from_numpy(rows))
    np.testing.assert_array_equal(tpool[:P].numpy(), np.asarray(want))


# --------------------------------------------------------------------- #
# prefill
# --------------------------------------------------------------------- #

def _prefill_inputs(B, c, H, Hkv, D, page, maxp, spare=3, seed=0):
    rs = np.random.RandomState(seed)
    P = B * maxp + spare
    q = rs.randn(B, c, H, D).astype(np.float32)
    k = rs.randn(B, c, Hkv, D).astype(np.float32)
    v = rs.randn(B, c, Hkv, D).astype(np.float32)
    kp = rs.randn(P, page, Hkv, D).astype(np.float32)
    vp = rs.randn(P, page, Hkv, D).astype(np.float32)
    bt = rs.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    return q, k, v, kp, vp, bt


def _both(q, k, v, kp, vp, bt, starts, lengths, dtype="float32"):
    """(JAX oracle (out, kp, vp), port plain version (out, kp, vp))."""
    starts = np.asarray(starts, np.int32)
    lengths = np.asarray(lengths, np.int32)
    j = [_cast(a, dtype) for a in (q, k, v, kp, vp)]
    want = JR.paged_prefill_reference(
        *[x[0] for x in j], jnp.asarray(bt), jnp.asarray(starts),
        jnp.asarray(lengths))
    tq, tk, tv, tkp, tvp = [x[1] for x in j]
    out = TR.paged_prefill_reference(
        tq, tk, tv, tkp, tvp, torch.from_numpy(bt),
        torch.from_numpy(starts), torch.from_numpy(lengths))
    return want, (out, tkp, tvp)


def _assert_triple(want, got, lengths, c, dtype="float32"):
    out_w, kp_w, vp_w = map(np_of, want)
    out_g, kp_g, vp_g = map(np_of, got)
    # outputs only matter on real rows; pools must match everywhere
    valid = np.arange(c)[None, :] < np.asarray(lengths)[:, None]
    np.testing.assert_allclose(out_g[valid], out_w[valid], **tol(dtype))
    np.testing.assert_array_equal(kp_g, kp_w)
    np.testing.assert_array_equal(vp_g, vp_w)


@pytest.mark.parametrize("B,c,H,Hkv,D,page,maxp", [
    (2, 8, 4, 2, 64, 8, 3),       # GQA, mid-chunk
    (1, 16, 2, 2, 64, 4, 5),      # MHA, small pages
    (2, 8, 4, 1, 128, 16, 2),     # MQA, wide head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_plain_matches_jax_oracle(B, c, H, Hkv, D, page, maxp, dtype):
    q, k, v, kp, vp, bt = _prefill_inputs(B, c, H, Hkv, D, page, maxp)
    starts = np.array([page, 0][:B] + [0] * max(0, B - 2))[:B]
    lengths = np.full((B,), c)
    want, got = _both(q, k, v, kp, vp, bt, starts, lengths, dtype)
    _assert_triple(want, got, lengths, c, dtype)


def test_prefill_plain_masked_padded_rows():
    """Rows padded below the bucket — including inert length-0 rows —
    write nothing: their pool pages are bit-untouched."""
    B, c, H, Hkv, D, page, maxp = 3, 8, 4, 2, 64, 8, 3
    q, k, v, kp, vp, bt = _prefill_inputs(B, c, H, Hkv, D, page, maxp, seed=7)
    lengths = np.array([c, 3, 0])          # full / partial / inert
    want, got = _both(q, k, v, kp, vp, bt, np.array([0, 4, 0]), lengths)
    _assert_triple(want, got, lengths, c)
    np.testing.assert_array_equal(got[1].numpy()[bt[2]], kp[bt[2]])
    p0 = bt[1, 0]                          # partial row: [4+3, 8) untouched
    np.testing.assert_array_equal(got[1].numpy()[p0, 7:], kp[p0, 7:])


@pytest.mark.parametrize("c", [8, 16, 64])
@pytest.mark.parametrize("ln_kind", ["one", "edge", "full"])
def test_prefill_plain_bucket_ladder_edges(c, ln_kind):
    B, H, Hkv, D, page = 2, 4, 2, 64, 16
    maxp = max(2, (c + page - 1) // page + 1)
    q, k, v, kp, vp, bt = _prefill_inputs(B, c, H, Hkv, D, page, maxp,
                                          seed=c)
    ln = {"one": 1, "edge": c - 1, "full": c}[ln_kind]
    lengths = np.array([ln, max(1, ln - 1)])
    want, got = _both(q, k, v, kp, vp, bt, np.array([0, page]), lengths)
    _assert_triple(want, got, lengths, c)


def test_prefill_plain_attach_then_diverge():
    """Two rows share a physical prefix page (a registry attach); each
    prefills only its private continuation.  The shared page is read by
    both and written by neither."""
    B, c, H, Hkv, D, page, maxp = 2, 8, 4, 2, 64, 8, 3
    q, k, v, kp, vp, bt = _prefill_inputs(B, c, H, Hkv, D, page, maxp,
                                          seed=11)
    bt[1, 0] = bt[0, 0]
    lengths = np.array([c, c])
    want, got = _both(q, k, v, kp, vp, bt, np.array([page, page]), lengths)
    _assert_triple(want, got, lengths, c)
    shared = bt[0, 0]
    np.testing.assert_array_equal(got[1].numpy()[shared], kp[shared])
    np.testing.assert_array_equal(got[2].numpy()[shared], vp[shared])
    assert not np.allclose(got[0].numpy()[0], got[0].numpy()[1])


def test_prefill_plain_cow_boundary_page():
    """A row resuming mid-page writes only positions >= start there."""
    B, c, H, Hkv, D, page, maxp = 1, 8, 4, 2, 64, 8, 2
    q, k, v, kp, vp, bt = _prefill_inputs(B, c, H, Hkv, D, page, maxp,
                                          seed=13)
    lengths = np.array([3])
    want, got = _both(q, k, v, kp, vp, bt, np.array([5]), lengths)
    _assert_triple(want, got, lengths, c)
    p0 = bt[0, 0]
    np.testing.assert_array_equal(got[1].numpy()[p0, :5], kp[p0, :5])


def test_prefill_plain_matches_pallas_interpret():
    B, c, H, Hkv, D, page, maxp = 1, 8, 4, 2, 64, 8, 2
    q, k, v, kp, vp, bt = _prefill_inputs(B, c, H, Hkv, D, page, maxp,
                                          seed=17)
    starts, lengths = np.array([5], np.int32), np.array([6], np.int32)
    want = paged_prefill_attention(
        *map(jnp.asarray, (q, k, v, kp, vp, bt, starts, lengths)),
        interpret=True)
    _, got = _both(q, k, v, kp, vp, bt, starts, lengths)
    out_w, kp_w, vp_w = map(np.asarray, want)
    np.testing.assert_allclose(got[0].numpy()[0, :6], out_w[0, :6],
                               **tol("f"))
    np.testing.assert_allclose(got[1].numpy(), kp_w, **tol("f"))
    np.testing.assert_allclose(got[2].numpy(), vp_w, **tol("f"))


# --------------------------------------------------------------------- #
# dispatch: plain versions only for CPU tensors, no fallback elsewhere
# --------------------------------------------------------------------- #

def test_ops_use_plain_versions_on_cpu_tensors():
    d0, p0 = TK.paged_decode_cuda.launches, TK.paged_prefill_cuda.launches
    q, kp, vp, bt, ctx = _decode_inputs(2, 8, 2, 64, 16, 4)
    args = tuple(map(torch.from_numpy, (q, kp, vp, bt, ctx)))
    assert torch.equal(TO.paged_decode(*args),
                       TR.paged_decode_reference(*args))
    q, k, v, kp, vp, bt = _prefill_inputs(2, 8, 4, 2, 64, 8, 3)
    se = (torch.tensor([8, 0], dtype=torch.int32),
          torch.tensor([8, 5], dtype=torch.int32))
    pools = [torch.from_numpy(kp), torch.from_numpy(vp)]
    pools2 = [p.clone() for p in pools]
    out = TO.paged_prefill(*map(torch.from_numpy, (q, k, v)), *pools,
                           torch.from_numpy(bt), *se)
    ref = TR.paged_prefill_reference(*map(torch.from_numpy, (q, k, v)),
                                     *pools2, torch.from_numpy(bt), *se)
    assert torch.equal(out, ref) and torch.equal(pools[0], pools2[0])
    assert (TK.paged_decode_cuda.launches, TK.paged_prefill_cuda.launches) \
        == (d0, p0)


def test_cuda_wrappers_refuse_non_cuda_tensors():
    """The kernel wrappers check before anything is built or launched:
    a CPU tensor is refused, never quietly run through the plain
    version."""
    q, kp, vp, bt, ctx = map(torch.from_numpy,
                             _decode_inputs(2, 8, 2, 64, 16, 4))
    with pytest.raises(ValueError, match="expected a tensor on"):
        TK.paged_decode_cuda(q, kp, vp, bt, ctx)
    q, k, v, kp, vp, bt = map(torch.from_numpy,
                              _prefill_inputs(1, 8, 4, 2, 64, 8, 2))
    z = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a tensor on"):
        TK.paged_prefill_cuda(q, k, v, kp, vp, bt, z, z)
