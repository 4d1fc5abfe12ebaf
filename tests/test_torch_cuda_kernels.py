"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Every test is marked ``cuda`` and skips where there is none (the
kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention import ref

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _tables(gen, B, maxp, P):
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * maxp]
    return perm.reshape(B, maxp).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,D,page,npages", [
    (2, 8, 2, 64, 16, 4), (4, 4, 4, 64, 32, 2), (1, 8, 1, 128, 64, 3),
    (8, 32, 4, 64, 16, 32), (3, 6, 1, 128, 8, 5)])
def test_decode_kernel_matches_plain(gen, dtype, B, H, Hkv, D, page, npages):
    P = B * npages + 3
    q = _randn(gen, B, H, D, dtype=dtype)
    kp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    vp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    bt = _tables(gen, B, npages, P)
    ctx = torch.randint(1, page * npages + 1, (B,), generator=gen,
                        device="cuda", dtype=torch.int32)
    n0 = pa.paged_decode_cuda.launches
    got = ops.paged_decode(q, kp, vp, bt, ctx)
    assert pa.paged_decode_cuda.launches == n0 + 1
    torch.testing.assert_close(got.float(),
                               ref.paged_decode_reference(q, kp, vp, bt,
                                                          ctx).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,c,H,Hkv,D,page,maxp,starts,lengths", [
    (2, 8, 4, 2, 64, 8, 3, [8, 0], [8, 8]),
    (3, 8, 4, 2, 64, 8, 3, [0, 4, 0], [8, 3, 0]),          # padded rows
    (1, 8, 4, 2, 64, 8, 2, [5], [3]),                      # mid-page start
    (2, 16, 4, 1, 128, 16, 3, [16, 0], [16, 1]),
    (8, 128, 32, 4, 64, 16, 32, [0, 128, 0, 128, 192, 192, 0, 128],
     [128, 128, 128, 128, 64, 64, 128, 128])])
def test_prefill_kernel_matches_plain(gen, dtype, B, c, H, Hkv, D, page,
                                      maxp, starts, lengths):
    P = B * maxp + 3
    q = _randn(gen, B, c, H, D, dtype=dtype)
    k = _randn(gen, B, c, Hkv, D, dtype=dtype)
    v = _randn(gen, B, c, Hkv, D, dtype=dtype)
    kp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    vp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    bt = _tables(gen, B, maxp, P)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kp2, vp2 = kp.clone(), vp.clone()
    got = ops.paged_prefill(q, k, v, kp, vp, bt, st, ln)
    want = ref.paged_prefill_reference(q, k, v, kp2, vp2, bt, st, ln)
    valid = torch.arange(c, device="cuda")[None] < ln[:, None]
    torch.testing.assert_close(got[valid].float(), want[valid].float(),
                               **TOL[dtype])
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 2, 8, 32, dtype=torch.float32)            # D = 32
    kp = _randn(gen, 4, 16, 2, 32, dtype=torch.float32)
    bt = torch.zeros((2, 2), dtype=torch.int32, device="cuda")
    ctx = torch.ones((2,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_cuda(q, kp, kp, bt, ctx)
    q = _randn(gen, 2, 8, 64, dtype=torch.float16)
    kp = _randn(gen, 4, 16, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        pa.paged_decode_cuda(q, kp, kp, bt, ctx)
    q = _randn(gen, 2, 8, 64, dtype=torch.float32)
    kp = _randn(gen, 4, 12, 2, 64, dtype=torch.float32)      # page 12
    with pytest.raises(ValueError, match="page size"):
        pa.paged_decode_cuda(q, kp, kp, bt, ctx)
    kp = _randn(gen, 4, 16, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_cuda(q, kp, kp, bt.t().contiguous().t(), ctx)


# --------------------------------------------------------------------- #
# full-sequence flash attention (B3)
# --------------------------------------------------------------------- #

def _qkv(gen, B, S, H, Hkv, D, dtype):
    return (_randn(gen, B, S, H, D, dtype=dtype),
            _randn(gen, B, S, Hkv, D, dtype=dtype),
            _randn(gen, B, S, Hkv, D, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 128, 8, 1, 128),
    (2, 100, 4, 2, 64), (1, 512, 2, 2, 128),
    (2, 512, 32, 4, 64),              # TinyLlama-1.1B, G = 8
    (1, 512, 15, 5, 64),              # SmolLM-360M, G = 3, H = 15
    (1, 37, 6, 2, 128)])
def test_flash_kernel_matches_plain(gen, dtype, B, S, H, Hkv, D):
    q, k, v = _qkv(gen, B, S, H, Hkv, D, dtype)
    n0 = fa.flash_attention_cuda.launches
    got = fa_ops.flash_attention(q, k, v)
    assert fa.flash_attention_cuda.launches == n0 + 1
    want = fa_ref.attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, **TOL[dtype])
    assert got.dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window,prefix_len,S", [
    (True, 16, 0, 256), (True, 64, 0, 256), (True, 0, 32, 128),
    (True, 0, 200, 256),               # prefix tiles above the diagonal
    (True, 16, 48, 256), (False, 0, 0, 100), (False, 0, 0, 128)])
def test_flash_kernel_masks_match_plain(gen, causal, window, prefix_len, S):
    q, k, v = _qkv(gen, 1, S, 4, 2, 64, torch.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.testing.assert_close(got, fa_ref.attention_reference(q, k, v, **kw),
                               **TOL[torch.float32])


@pytest.mark.cuda
def test_flash_kernel_has_no_backward(gen):
    q, k, v = _qkv(gen, 1, 64, 4, 2, 64, torch.float32)
    q.requires_grad_(True)
    out = fa_ops.flash_attention(q, k, v)
    with pytest.raises(fa_ops.NoBackwardError):
        out.sum().backward()


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 16, 4, 2, 32, torch.float32)       # D = 32
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _qkv(gen, 1, 16, 4, 2, 64, torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _qkv(gen, 1, 16, 5, 2, 64, torch.float32)       # 5 over 2
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _qkv(gen, 1, 16, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="expected a tensor on"):
        fa.flash_attention_cuda(q, k.cpu(), v)
