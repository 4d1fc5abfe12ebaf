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
from repro_torch.kernels.rwkv_scan import ops as wkv_ops
from repro_torch.kernels.rwkv_scan import ref as wkv_ref
from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
from repro_torch.models.ssm import pick_chunk

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
#: the kernel each dtype selects in B2 and B3
VARIANT = {torch.float32: "mma_3xtf32", torch.bfloat16: "wgmma"}


def _variants(fn):
    return dict(fn.launches_by_variant)


def _assert_one_launch_of(fn, before, dtype):
    """``fn`` made exactly one launch since ``before``, of the variant
    ``dtype`` selects, and none of the other."""
    after = _variants(fn)
    for var, n in after.items():
        assert n == before[var] + (var == VARIANT[dtype]), (dtype, before,
                                                            after)


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


#: the decode kernel each dtype selects (B1)
DECODE_VARIANT = {torch.float32: "split_simt", torch.bfloat16: "split_mma"}


def _split_edges(B, Hkv, width):
    """B contexts on, one before and one past the kernel's split
    boundaries, ctx = 1 and the table's full width."""
    span = pa.decode_span(B, Hkv, width)
    edges = [1, span - 1, span, span + 1, 2 * span - 1, 2 * span,
             2 * span + 1, 3 * span, width - 1, width]
    edges = sorted({min(max(c, 1), width) for c in edges})
    return [edges[b % len(edges)] for b in range(B)]


def _check_decode(q, kp, vp, bt, ctx, dtype):
    n0 = pa.paged_decode_cuda.launches
    before = dict(pa.paged_decode_cuda.launches_by_variant)
    got = ops.paged_decode(q, kp, vp, bt, ctx)
    assert pa.paged_decode_cuda.launches == n0 + 1
    after = pa.paged_decode_cuda.launches_by_variant
    assert after == {k: n + (k == DECODE_VARIANT[dtype])
                     for k, n in before.items()}, (dtype, before, after)
    torch.testing.assert_close(got.float(),
                               ref.paged_decode_reference(q, kp, vp, bt,
                                                          ctx).float(),
                               **TOL[dtype])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,D,page,npages,ctx", [
    (2, 8, 2, 64, 16, 4, None), (4, 4, 4, 64, 32, 2, None),
    (1, 8, 1, 128, 64, 3, None), (8, 32, 4, 64, 16, 32, None),
    (3, 6, 1, 128, 8, 5, None),
    # contexts at the split boundaries (span 64): G = 8, 3 and 1
    (10, 8, 1, 64, 16, 16, "edges"), (10, 3, 1, 64, 16, 16, "edges"),
    (10, 2, 2, 64, 16, 16, "edges"),
    # D = 128 with pages 8 and 64
    (10, 16, 2, 128, 8, 40, "edges"), (10, 8, 4, 128, 64, 6, "edges"),
    # spans 128 and 256: two and four chunks per warp through the ring
    (16, 16, 8, 64, 16, 64, "edges"), (32, 16, 8, 64, 16, 64, "edges"),
    # B = 1 at ctx 2048 (TinyLlama's heads); Llama-3-8B's heads at 2048
    (1, 32, 4, 64, 16, 128, [2048]), (8, 32, 8, 128, 16, 128, [2048] * 8),
    (8, 32, 8, 128, 16, 128, [1, 127, 128, 129, 1000, 2047, 2048, 64])])
def test_decode_kernel_matches_plain(gen, dtype, B, H, Hkv, D, page, npages,
                                     ctx):
    P = B * npages + 3
    q = _randn(gen, B, H, D, dtype=dtype)
    kp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    vp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    bt = _tables(gen, B, npages, P)
    if ctx is None:
        ctx = torch.randint(1, page * npages + 1, (B,), generator=gen,
                            device="cuda", dtype=torch.int32)
    else:
        if ctx == "edges":
            ctx = _split_edges(B, Hkv, page * npages)
        ctx = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    _check_decode(q, kp, vp, bt, ctx, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_stale_and_shared_rows(gen, dtype):
    """An inactive row (zeroed table, ctx 10,000) reads page 0 only; two
    rows that map the same prefix pages read them each."""
    B, H, Hkv, D, page, npages = 4, 16, 2, 64, 16, 12
    P = B * npages + 3
    q = _randn(gen, B, H, D, dtype=dtype)
    kp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    vp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    bt = _tables(gen, B, npages, P)
    bt[1] = 0
    bt[3, :6] = bt[2, :6]
    ctx = torch.tensor([70, 10_000, 150, 190], dtype=torch.int32,
                       device="cuda")
    _check_decode(q, kp, vp, bt, ctx, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_repeats_bit_for_bit(gen, dtype):
    """Two calls in a row give the same bits: nothing persists between
    calls, and the merge adds the partials in split order."""
    B, H, Hkv, D, page, npages = 8, 32, 4, 64, 16, 32
    P = B * npages + 3
    q = _randn(gen, B, H, D, dtype=dtype)
    kp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    vp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    bt = _tables(gen, B, npages, P)
    ctx = torch.tensor([260 + 5 * b for b in range(B)], dtype=torch.int32,
                       device="cuda")
    first = _check_decode(q, kp, vp, bt, ctx, dtype)
    for _ in range(3):
        assert torch.equal(pa.paged_decode_cuda(q, kp, vp, bt, ctx), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_on_two_streams_at_once(gen, dtype):
    """Decodes enqueued on two streams, neither waiting for the other,
    each match the plain version: no state is shared between calls."""
    B, H, Hkv, D, page, npages = 8, 32, 4, 64, 16, 32
    P = B * npages + 3
    cases = []
    for _ in range(2):
        q = _randn(gen, B, H, D, dtype=dtype)
        kp = _randn(gen, P, page, Hkv, D, dtype=dtype)
        vp = _randn(gen, P, page, Hkv, D, dtype=dtype)
        bt = _tables(gen, B, npages, P)
        ctx = torch.randint(65, page * npages + 1, (B,), generator=gen,
                            device="cuda", dtype=torch.int32)
        cases.append((q, kp, vp, bt, ctx))
    streams = [torch.cuda.Stream() for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        for st, case in zip(streams, cases):
            with torch.cuda.stream(st):
                outs.append(pa.paged_decode_cuda(*case))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        torch.testing.assert_close(
            got.float(), ref.paged_decode_reference(*cases[i % 2]).float(),
            **TOL[dtype])


@pytest.mark.cuda
def test_decode_span_rule(gen):
    """The span the kernel picks: 64 at the serving shapes, doubling
    while the grid passes 1,024 blocks or 64 splits per (row, kv head),
    never more than 64 splits."""
    assert pa.decode_span(8, 4, 512) == 64
    assert pa.decode_span(1, 4, 2048) == 64
    assert pa.decode_span(8, 8, 2048) == 128
    assert pa.decode_span(32, 8, 1024) == 256
    assert pa.decode_span(1, 1, 1 << 16) == 1024
    assert pa.decode_span(2, 2, 40) == 64
    for B, Hkv, width in [(8, 4, 512), (64, 8, 4096), (1, 1, 1 << 16),
                          (3, 5, 40), (128, 8, 8192)]:
        span = pa.decode_span(B, Hkv, width)
        assert -(-width // span) <= 64


def _written_slots(bt, st, ln, c, P, page):
    """(P, page) bool: the pool slots the prefill writes (chunk row
    r < length[b] at position start[b] + r, through the block table)."""
    pos = st[:, None].long() + torch.arange(c, device="cuda")[None]
    valid = torch.arange(c, device="cuda")[None] < ln[:, None]
    slot = torch.clamp(pos // page, 0, bt.shape[1] - 1)
    dest = torch.gather(bt.long(), 1, slot) * page + pos % page
    written = torch.zeros(P * page, dtype=torch.bool, device="cuda")
    written[dest[valid]] = True
    return written.view(P, page)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,c,H,Hkv,D,page,maxp,starts,lengths,shared", [
    (2, 8, 4, 2, 64, 8, 3, [8, 0], [8, 8], 0),
    (3, 8, 4, 2, 64, 8, 3, [0, 4, 0], [8, 3, 0], 0),   # padded, length-0
    (1, 8, 4, 2, 64, 8, 2, [5], [3], 0),               # mid-page start
    (2, 16, 4, 1, 128, 16, 3, [16, 0], [16, 1], 0),
    (8, 128, 32, 4, 64, 16, 32, [0, 128, 0, 128, 192, 192, 0, 128],
     [128, 128, 128, 128, 64, 64, 128, 128], 0),       # the serving round
    # page sizes 8 / 16 / 32 / 64, starts not multiples of the 64-key tile
    (2, 32, 16, 2, 64, 8, 20, [37, 100], [32, 20], 0),
    (2, 32, 16, 2, 64, 16, 10, [70, 3], [25, 32], 0),
    (2, 64, 8, 1, 64, 32, 6, [90, 0], [64, 40], 0),
    (2, 64, 8, 1, 128, 64, 4, [130, 65], [50, 64], 0),
    # a prefix that ends mid-page, with padded rows
    (3, 16, 24, 4, 128, 16, 6, [40, 41, 0], [16, 9, 0], 0),
    # a prefix-registry attach: two rows share their first full pages; at
    # a mid-page start each writes into its own copy of the boundary page
    # (the copy-on-write guard's), at a page boundary into fresh pages
    (2, 16, 8, 1, 64, 16, 6, [40, 40], [16, 12], 2),
    (2, 16, 8, 1, 64, 16, 6, [48, 48], [16, 16], 3),
    # D = 128 with G = 1 (qwen2-moe) and G = 8 (qwen3-moe): ragged and
    # length-0 rows, starts off the 32-key tile
    (4, 128, 16, 16, 128, 16, 20, [0, 128, 37, 200], [128, 100, 0, 57], 0),
    (3, 64, 32, 4, 128, 8, 40, [0, 131, 250], [64, 1, 63], 0),
    # D = 256 (PaliGemma, G = 8): 8 warps a CTA, padded rows, a shared
    # prefix, pages 8 and 64
    (3, 128, 8, 1, 256, 16, 24, [0, 192, 130], [128, 64, 0], 0),
    (4, 96, 8, 1, 256, 8, 40, [0, 37, 100, 200], [96, 50, 0, 80], 0),
    (2, 64, 8, 1, 256, 64, 4, [65, 65], [64, 30], 1),
    # MusicGen's round: 256-row chunks over prefixes up to 1,280, G = 1
    (8, 256, 24, 24, 64, 16, 128, [0, 256, 512, 768, 1024, 1280, 0, 256],
     [256] * 8, 0),
    (3, 256, 24, 24, 64, 16, 100, [1280, 999, 0], [256, 13, 0], 0)])
def test_prefill_kernel_matches_plain(gen, dtype, B, c, H, Hkv, D, page,
                                      maxp, starts, lengths, shared):
    P = B * maxp + 3
    q = _randn(gen, B, c, H, D, dtype=dtype)
    k = _randn(gen, B, c, Hkv, D, dtype=dtype)
    v = _randn(gen, B, c, Hkv, D, dtype=dtype)
    kp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    vp = _randn(gen, P, page, Hkv, D, dtype=dtype)
    bt = _tables(gen, B, maxp, P)
    if shared:
        bt[1:, :shared] = bt[0, :shared]
        if starts[0] % page:         # the boundary page, copied on write
            kp[bt[1:, shared].long()] = kp[bt[0, shared].long()].clone()
            vp[bt[1:, shared].long()] = vp[bt[0, shared].long()].clone()
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kp0, vp0 = kp.clone(), vp.clone()
    kp2, vp2 = kp.clone(), vp.clone()
    before = _variants(pa.paged_prefill_cuda)
    got = ops.paged_prefill(q, k, v, kp, vp, bt, st, ln)
    _assert_one_launch_of(pa.paged_prefill_cuda, before, dtype)
    want = ref.paged_prefill_reference(q, k, v, kp2, vp2, bt, st, ln)
    valid = torch.arange(c, device="cuda")[None] < ln[:, None]
    torch.testing.assert_close(got[valid].float(), want[valid].float(),
                               **TOL[dtype])
    assert not got[~valid].float().abs().any()   # padded rows: zeros
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    keep = ~_written_slots(bt, st, ln, c, P, page)
    assert torch.equal(kp[keep], kp0[keep]) and \
        torch.equal(vp[keep], vp0[keep])


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
    (2, 512, 15, 5, 64),
    (1, 37, 6, 2, 128), (2, 37, 15, 5, 64), (1, 200, 6, 3, 128),
    (1, 2048, 32, 4, 64),             # long S: the heaviest tiles first
    (2, 512, 32, 4, 128), (1, 333, 16, 16, 128),   # D = 128, G = 8 and 1
    (2, 512, 8, 1, 256), (1, 77, 8, 1, 256),       # D = 256 (PaliGemma)
    (1, 300, 16, 2, 256)])
def test_flash_kernel_matches_plain(gen, dtype, B, S, H, Hkv, D):
    q, k, v = _qkv(gen, B, S, H, Hkv, D, dtype)
    n0 = fa.flash_attention_cuda.launches
    before = _variants(fa.flash_attention_cuda)
    got = fa_ops.flash_attention(q, k, v)
    assert fa.flash_attention_cuda.launches == n0 + 1
    _assert_one_launch_of(fa.flash_attention_cuda, before, dtype)
    want = fa_ref.attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, **TOL[dtype])
    assert got.dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,prefix_len,S", [
    (True, 16, 0, 256), (True, 64, 0, 256), (True, 0, 32, 128),
    (True, 0, 200, 256),               # prefix tiles above the diagonal
    (True, 16, 48, 256), (False, 0, 0, 100), (False, 0, 0, 128),
    (True, 100, 0, 700),               # whole tiles outside the window
    (True, 130, 70, 500),              # a window and a mid-tile prefix
    (True, 0, 0, 37), (False, 0, 0, 37)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_kernel_masks_match_plain(gen, dtype, causal, window,
                                        prefix_len, S, D):
    q, k, v = _qkv(gen, 1, S, 4, 2, D, dtype)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    before = _variants(fa.flash_attention_cuda)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    _assert_one_launch_of(fa.flash_attention_cuda, before, dtype)
    torch.testing.assert_close(got.float(),
                               fa_ref.attention_reference(
                                   q.float(), k.float(), v.float(), **kw),
                               **TOL[dtype])


#: every variant of B1-B4, by the dtype it runs in (B4: its columns a
#: CTA, picked from B x H), at each head dim it takes
REPEAT_CASES = (
    [(kernel, dtype, D) for kernel in ("paged_decode", "paged_prefill",
                                       "flash_attention")
     for dtype in (torch.float32, torch.bfloat16) for D in (64, 128, 256)]
    + [("wkv6_colsplit32", torch.float32, 64),
       ("wkv6_colsplit64", torch.float32, 64)])
REPEATS = 20


def _repeat_call(gen, kernel, dtype, D):
    """(a call of ``kernel``'s variant for ``dtype`` on fixed inputs ->
    its outputs, the wrapper, the variant it must launch)."""
    if kernel == "paged_decode":      # several splits: the merge runs
        B, H, Hkv, page, npages = 3, 16, 2, 16, 32
        P = B * npages + 3
        q = _randn(gen, B, H, D, dtype=dtype)
        kp, vp = (_randn(gen, P, page, Hkv, D, dtype=dtype)
                  for _ in range(2))
        bt = _tables(gen, B, npages, P)
        ctx = torch.tensor([1, 300, 512], dtype=torch.int32, device="cuda")
        return (lambda: (pa.paged_decode_cuda(q, kp, vp, bt, ctx),),
                pa.paged_decode_cuda, DECODE_VARIANT[dtype])
    if kernel == "paged_prefill":     # its pool writes repeat too
        B, c, H, Hkv, page, maxp = 3, 128, 16, 2, 16, 24
        P = B * maxp + 3
        q = _randn(gen, B, c, H, D, dtype=dtype)
        k, v = (_randn(gen, B, c, Hkv, D, dtype=dtype) for _ in range(2))
        kp, vp = (_randn(gen, P, page, Hkv, D, dtype=dtype)
                  for _ in range(2))
        bt = _tables(gen, B, maxp, P)
        st = torch.tensor([0, 200, 77], dtype=torch.int32, device="cuda")
        ln = torch.tensor([128, 90, 0], dtype=torch.int32, device="cuda")

        def call():
            kp2, vp2 = kp.clone(), vp.clone()
            return (pa.paged_prefill_cuda(q, k, v, kp2, vp2, bt, st, ln),
                    kp2, vp2)
        return call, pa.paged_prefill_cuda, VARIANT[dtype]
    if kernel == "flash_attention":
        q, k, v = _qkv(gen, 2, 300, 8, 2, D, dtype)
        return (lambda: (fa.flash_attention_cuda(q, k, v, window=100,
                                                 prefix_len=40),),
                fa.flash_attention_cuda, VARIANT[dtype])
    B, S, H = (1, 37, 4) if kernel == "wkv6_colsplit32" else (1, 21, 265)
    r, k, v, w, u, s0 = _wkv_inputs(gen, B, S, H, D, s0=True)
    assert f"wkv6_colsplit{wkv.columns(B, H, D)}" == kernel
    return lambda: wkv.wkv6_cuda(r, k, v, w, u, s0), wkv.wkv6_cuda, None


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype,D", REPEAT_CASES)
def test_fp32_attention_kernels_repeat_bit_for_bit(gen, kernel, dtype, D):
    """Every variant of B1-B4 (fp32 B2 and B3 the 3xTF32 kernels) called
    again and again on the same inputs gives the same bits: no atomics,
    no state between calls, no read of memory the kernel did not write;
    B2's pool writes too."""
    call, fn, variant = _repeat_call(gen, kernel, dtype, D)
    n0, before = fn.launches, dict(getattr(fn, "launches_by_variant", {}))
    first = call()
    assert fn.launches == n0 + 1
    if variant is not None:
        assert fn.launches_by_variant == {
            k: n + (k == variant) for k, n in before.items()}
    for _ in range(REPEATS):
        for got, want in zip(call(), first):
            assert torch.equal(got, want)


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


# --------------------------------------------------------------------- #
# the WKV6 recurrence (B4)
# --------------------------------------------------------------------- #

#: tests/test_kernels.py's tolerances: 3e-5, and 1e-4 at the decay extremes
WKV_TOL = dict(rtol=3e-5, atol=3e-5)
WKV_TOL_EXTREME = dict(rtol=1e-4, atol=1e-4)


def _wkv_inputs(gen, B, S, H, D, wval=None, s0=False):
    """tests/test_kernels.py's distributions: r, k, v ~ 0.3 N(0, 1), w in
    (0.45, 0.95), u ~ 0.1 N(0, 1); ``wval`` a constant decay (u = 0)."""
    r, k, v = (0.3 * _randn(gen, B, S, H, D, dtype=torch.float32)
               for _ in range(3))
    if wval is None:
        w = torch.sigmoid(_randn(gen, B, S, H, D, dtype=torch.float32)) \
            * 0.5 + 0.45
        u = 0.1 * _randn(gen, H, D, dtype=torch.float32)
    else:
        w = torch.full((B, S, H, D), wval, device="cuda")
        u = torch.zeros((H, D), device="cuda")
    st = _randn(gen, B, H, D, D, dtype=torch.float32) if s0 else None
    return r, k, v, w, u, st


def _check_wkv(case, chunk, tol):
    r, k, v, w, u, s0 = case
    n0 = wkv.wkv6_cuda.launches
    y, s = wkv_ops.wkv6(r, k, v, w, u, s0=s0, chunk=chunk)
    assert wkv.wkv6_cuda.launches == n0 + 1
    for want in (wkv_ref.wkv6_chunked_ref(r, k, v, w, u, s0, chunk),
                 wkv_ref.wkv6_reference(r, k, v, w, u, s0)):
        torch.testing.assert_close(y, want[0], **tol)
        torch.testing.assert_close(s, want[1], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,chunk", [
    (1, 64, 2, 32, 16), (2, 128, 4, 32, 64), (1, 96, 2, 64, 32),
    (2, 64, 2, 32, 64),                       # tests/test_kernels.py's sweep
    (8, 64, 64, 64, 64),                      # the engine round, full width
    (3, 40, 5, 8, 8)])                        # the reduced config's D
def test_wkv6_kernel_matches_plain(gen, B, S, H, D, chunk):
    _check_wkv(_wkv_inputs(gen, B, S, H, D), chunk, WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("wval", [0.01, 0.999])
def test_wkv6_kernel_decay_extremes(gen, wval):
    _check_wkv(_wkv_inputs(gen, 1, 64, 2, 32, wval=wval), 16,
               WKV_TOL_EXTREME)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [37, 200, 448, 127])
def test_wkv6_kernel_any_length_and_state(gen, S):
    """Any S (pick_chunk's Q for the plain form: 37, 8, 64, 1), from a
    random nonzero initial state."""
    _check_wkv(_wkv_inputs(gen, 2, S, 4, 64, s0=True), pick_chunk(S, 64),
               WKV_TOL)


@pytest.mark.cuda
def test_wkv6_kernel_padded_steps_keep_the_state(gen):
    """Steps with w = 1, k = 0 leave S bit for bit as it was; a state
    carried over two calls repeats one call's operations."""
    r, k, v, w, u, s0 = _wkv_inputs(gen, 2, 24, 4, 64, s0=True)
    y, s = wkv.wkv6_cuda(r, k, v, w, u, s0)
    pad = lambda t, val: torch.cat(  # noqa: E731
        [t, torch.full_like(t[:, :8], val)], dim=1)
    yp, sp = wkv.wkv6_cuda(pad(r, 0.5), pad(k, 0.0), pad(v, 0.7),
                           pad(w, 1.0), u, s0)
    assert torch.equal(sp, s) and torch.equal(yp[:, :24], y)
    y1, s1 = wkv.wkv6_cuda(r[:, :10].contiguous(), k[:, :10].contiguous(),
                           v[:, :10].contiguous(), w[:, :10].contiguous(),
                           u, s0)
    y2, s2 = wkv.wkv6_cuda(r[:, 10:].contiguous(), k[:, 10:].contiguous(),
                           v[:, 10:].contiguous(), w[:, 10:].contiguous(),
                           u, s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(s2, s)


#: (B, S, H, D) on each side of the kernel's grid rule (rwkv_scan.columns):
#: D = 64 switches from 16-step to 8-step tiles past 66 heads and from 32
#: to 64 columns per CTA past 264; D = 32 and D = 8 have one split each.
#: S is off the tile so the last tile is partial.
WKV_EDGES = [(1, 37, 66, 64), (1, 37, 67, 64), (4, 21, 66, 64),
             (5, 21, 53, 64), (1, 5, 265, 64), (8, 1, 64, 64),
             (2, 37, 4, 32), (3, 13, 5, 8)]


@pytest.mark.cuda
def test_wkv6_columns_rule(gen):
    """The split the C entry picks: 32 columns per CTA while two CTAs per
    head fit four per SM on 132 SMs, then a head per CTA; one split for
    D = 32 and D = 8; 0 for a head dim it does not take."""
    assert [wkv.columns(B, H, D) for B, _, H, D in WKV_EDGES] == \
        [32, 32, 32, 64, 64, 64, 32, 8]
    assert wkv.columns(4, 64, 64) == 32 and wkv.columns(8, 64, 64) == 64
    assert wkv.columns(1, 1, 24) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D", WKV_EDGES)
def test_wkv6_kernel_at_the_split_edges(gen, B, S, H, D):
    _check_wkv(_wkv_inputs(gen, B, S, H, D, s0=True), pick_chunk(S, 64),
               WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(8, 64), (6, 53)])
def test_wkv6_batched_rows_equal_single_rows(gen, B, H):
    """Row b of a batched call is bit-equal to row b called alone, though
    the two calls split the state differently (64 and 32 columns per
    CTA): every sum's order depends on D alone."""
    r, k, v, w, u, s0 = _wkv_inputs(gen, B, 64, H, 64, s0=True)
    assert wkv.columns(B, H, 64) != wkv.columns(1, H, 64)
    y, s = wkv.wkv6_cuda(r, k, v, w, u, s0)
    for b in range(B):
        one = [t[b:b + 1].contiguous() for t in (r, k, v, w)]
        yb, sb = wkv.wkv6_cuda(*one, u, s0[b:b + 1].contiguous())
        assert torch.equal(yb, y[b:b + 1]) and torch.equal(sb, s[b:b + 1]), b


@pytest.mark.cuda
def test_wkv6_kernel_on_two_streams_at_once(gen):
    """Calls enqueued on two streams, neither waiting for the other, each
    match the plain version and repeat bit for bit: nothing is shared
    between calls."""
    cases = [_wkv_inputs(gen, 4, 64, 64, 64, s0=True),
             _wkv_inputs(gen, 1, 200, 64, 64)]
    streams = [torch.cuda.Stream() for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(5):
        for st, case in zip(streams, cases):
            with torch.cuda.stream(st):
                outs.append(wkv.wkv6_cuda(*case))
    torch.cuda.synchronize()
    for i, (y, s) in enumerate(outs):
        case = cases[i % 2]
        wy, ws = wkv_ref.wkv6_reference(*case)
        torch.testing.assert_close(y, wy, **WKV_TOL)
        torch.testing.assert_close(s, ws, **WKV_TOL)
        assert torch.equal(y, outs[i % 2][0]) and \
            torch.equal(s, outs[i % 2][1])


@pytest.mark.cuda
def test_wkv6_kernel_has_no_backward(gen):
    r, k, v, w, u, _ = _wkv_inputs(gen, 1, 16, 2, 32)
    r.requires_grad_(True)
    y, _ = wkv_ops.wkv6(r, k, v, w, u, chunk=16)
    with pytest.raises(wkv_ops.NoBackwardError):
        y.sum().backward()


@pytest.mark.cuda
def test_wkv6_wrapper_refuses_what_the_kernel_does_not_take(gen):
    r, k, v, w, u, _ = _wkv_inputs(gen, 1, 16, 2, 24)          # D = 24
    with pytest.raises(ValueError, match="head dim"):
        wkv.wkv6_cuda(r, k, v, w, u)
    r, k, v, w, u, _ = _wkv_inputs(gen, 1, 16, 2, 32)
    with pytest.raises(TypeError):
        wkv.wkv6_cuda(r.bfloat16(), k, v, w, u)
    with pytest.raises(ValueError, match="contiguous"):
        wkv.wkv6_cuda(r.transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError, match="expected a tensor on"):
        wkv.wkv6_cuda(r, k.cpu(), v, w, u)
    with pytest.raises(ValueError, match="s0"):
        wkv.wkv6_cuda(r, k, v, w, u, torch.zeros((1, 2, 32, 16),
                                                 device="cuda"))
    with pytest.raises(ValueError, match="u "):
        wkv.wkv6_cuda(r, k, v, w, u[:1])
    flat = torch.zeros(r.numel() + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        wkv.wkv6_cuda(flat[1:].view(r.shape), k, v, w, u)
