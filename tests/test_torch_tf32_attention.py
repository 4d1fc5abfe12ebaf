"""The arithmetic of the port's fp32 attention kernels (B2's and B3's
3xTF32 kernels over ``kernels/common/csrc/tf32_attention.cuh``) held
against the JAX package's oracles on the CPU.

The kernels cannot run here, so this file models what they compute: every
product a * b as big_a * small_b + small_a * big_b + big_a * big_b, where
big = tf32(x) and small = tf32(x - big) are rounded to nearest with ties
away from zero (``cvt.rna.tf32.f32``), products in fp32; the online
softmax's scale folded into exp2; P split like any operand; O / l at the
end.  That model, built into plain attention for B2 (pool pages through
block tables, starts and lengths) and B3 (causal, ``window``,
``prefix_len``), must stay within the fp32 path's tolerance (2e-5, as
``tests/test_kernels.py`` and ``chip_smoke.TOL``) of
``repro.kernels.paged_attention.ref.paged_prefill_reference`` and
``repro.kernels.flash_attention.ref.attention_reference``, at the shapes
of the fp32 rows of the port's kernel table with the batch cut; and one
TF32 product alone must not (the control).  The helpers live here only:
nothing in the package uses them.

Inputs are N(0, 1), made with numpy from a seed and fed to both sides."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_reference
from repro.kernels.paged_attention.ref import paged_prefill_reference

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
LOG2E = 1.4426950408889634


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds a finite x: add half a tf32 ulp
    to the magnitude's bits and clear the 13 low ones."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = round_tf32(x)
    return big, round_tf32(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b as the kernels take it: three TF32 products in fp32, the
    small terms first (``passes=1``: big @ big alone, one TF32 product)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if passes == 1:
        return ab @ bb
    return (ab @ bs + as_ @ bb) + ab @ bb


def softmax_pv(s, mask, v, D, passes=3):
    """The kernels' online softmax, whole: s (..., q, k) raw scores, mask
    of the same shape, v (..., k, D) -> (..., q, D)."""
    scale_log2 = LOG2E / math.sqrt(D)
    s = torch.where(mask, s, -math.inf)
    m = s.amax(-1, keepdim=True) * scale_log2
    m = torch.where(torch.isinf(m), 0.0, m)
    p = torch.exp2(s * scale_log2 - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return mm_3xtf32(p, v, passes) / l


def flash_3xtf32(q, k, v, *, causal=True, window=0, prefix_len=0,
                 passes=3):
    """B3's arithmetic: q (B, S, H, D), k/v (B, S, Hkv, D) fp32."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)   # b h g s d
    kt = k.permute(0, 2, 3, 1)[:, :, None]                   # b h 1 d s
    vt = v.permute(0, 2, 1, 3)[:, :, None]                   # b h 1 s d
    s = mm_3xtf32(qg, kt, passes)
    qp = torch.arange(S)[:, None]
    kp = torch.arange(S)[None]
    mask = torch.ones((S, S), dtype=torch.bool)
    if causal:
        mask = qp >= kp
        if window:
            mask &= (qp - kp) < window
        if prefix_len:
            mask |= kp < prefix_len
    o = softmax_pv(s, mask, vt, D, passes)                   # b h g s d
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def prefill_3xtf32(q, k, v, k_pool, v_pool, bt, starts, lengths, passes=3):
    """B2's arithmetic: the chunk written into each row's gathered pages,
    chunk row r attending over positions <= start + r; padded rows zero.
    q (B, c, H, D), k/v (B, c, Hkv, D), pools (P, page, Hkv, D)."""
    B, c, H, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    G = H // Hkv
    Smax = bt.shape[1] * page
    kg = k_pool[bt.long()].reshape(B, Smax, Hkv, D).clone()
    vg = v_pool[bt.long()].reshape(B, Smax, Hkv, D).clone()
    for b in range(B):
        n, s0 = int(lengths[b]), int(starts[b])
        kg[b, s0:s0 + n] = k[b, :n]
        vg[b, s0:s0 + n] = v[b, :n]
    qg = q.reshape(B, c, Hkv, G, D).permute(0, 2, 3, 1, 4)   # b h g c d
    s = mm_3xtf32(qg, kg.permute(0, 2, 3, 1)[:, :, None], passes)
    pos = starts.long()[:, None] + torch.arange(c)[None]       # (B, c)
    mask = (torch.arange(Smax)[None, None] <= pos[:, :, None])[:, None, None]
    o = softmax_pv(s, mask, vg.permute(0, 2, 1, 3)[:, :, None], D, passes)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, c, H, D)
    valid = torch.arange(c)[None] < lengths.long()[:, None]
    return torch.where(valid[:, :, None, None], o, 0.0), valid


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tables(rng, B, maxp, P):
    return rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)


def _beyond(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` outside ``TOL`` of ``want``."""
    return int(((got - want).abs() > TOL["atol"]
                + TOL["rtol"] * want.abs()).sum())


# --------------------------------------------------------------------- #
# the rounding
# --------------------------------------------------------------------- #

def test_round_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 2 - ulp / 2, 0.0, -0.0, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 2.0, 0.0,
                         -0.0, 3.0], dtype=torch.float64)
    assert torch.equal(round_tf32(x).double(), want)


def test_round_tf32_matches_a_float64_rounding_and_splits_exactly():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        _normal(rng, 100_000), _normal(rng, 1000) * 1e-30,
        _normal(rng, 1000) * 1e30]))
    xd = x.double()
    e = torch.floor(torch.log2(xd.abs()))
    ulp = torch.exp2(e - 10)
    want = torch.sign(xd) * torch.floor(xd.abs() / ulp + 0.5) * ulp
    got = round_tf32(x)
    assert torch.equal(got.double(), want)
    assert not (got.view(torch.int32) & 0x1FFF).any()    # 13 low bits 0
    big, small = split(x)
    rel = ((big.double() + small.double() - xd).abs() / xd.abs()).max()
    assert rel <= 2.0 ** -21


# --------------------------------------------------------------------- #
# B2: the fp32 rows' shapes (smoke engine: page 16, 32-page tables)
# --------------------------------------------------------------------- #

#: (H, Hkv, D, page, maxp, starts, lengths) of the fp32 B2 rows, batch cut
#: to two rows of each round (MusicGen: its longest prefix alone):
#: TinyLlama (D 64), qwen2-moe (D 128, G 1),
#: PaliGemma (D 256, G 8), MusicGen (D 64, G 1, 256-row chunks over
#: prefixes up to 1,280 in 2,048-position tables)
PREFILL_ROWS = {
    "tinyllama_d64": (32, 4, 64, 16, 32, [128, 192], [128, 64]),
    "qwen2_moe_d128": (16, 16, 128, 16, 32, [0, 192], [128, 64]),
    "paligemma_d256": (8, 1, 256, 16, 32, [128, 192], [128, 64]),
    "musicgen_d64": (24, 24, 64, 16, 128, [1280], [256]),
}


def _prefill_case(seed, H, Hkv, D, page, maxp, starts, lengths):
    rng = np.random.default_rng(seed)
    B = len(starts)
    c = max(lengths)
    P = B * maxp + 3
    arrs = (_normal(rng, B, c, H, D), _normal(rng, B, c, Hkv, D),
            _normal(rng, B, c, Hkv, D), _normal(rng, P, page, Hkv, D),
            _normal(rng, P, page, Hkv, D), _tables(rng, B, maxp, P),
            np.array(starts, np.int32), np.array(lengths, np.int32))
    return arrs


def _jax_prefill(arrs) -> torch.Tensor:
    out, _, _ = paged_prefill_reference(*map(jnp.asarray, arrs))
    return torch.from_numpy(np.array(out))


def _jax_flash(arrs, **kw) -> torch.Tensor:
    return torch.from_numpy(np.array(
        attention_reference(*map(jnp.asarray, arrs), **kw)))


@pytest.mark.parametrize("name", list(PREFILL_ROWS))
def test_b2_3xtf32_matches_the_jax_oracle(name):
    arrs = _prefill_case(11, *PREFILL_ROWS[name])
    want = _jax_prefill(arrs)
    got, valid = prefill_3xtf32(*map(torch.from_numpy, arrs))
    assert _beyond(got[valid], want[valid]) == 0, \
        (got[valid] - want[valid]).abs().max()
    assert not got[~valid].any()


def test_b2_padded_and_empty_rows_at_d256():
    """A padded row and a length-0 row (zeros out), starts off the tile."""
    arrs = _prefill_case(12, 8, 1, 256, 16, 32, [37, 0, 201], [96, 0, 50])
    want = _jax_prefill(arrs)
    got, valid = prefill_3xtf32(*map(torch.from_numpy, arrs))
    assert _beyond(got[valid], want[valid]) == 0
    assert not got[~valid].any() and int(valid.sum()) == 146


# --------------------------------------------------------------------- #
# B3: the fp32 rows' shapes
# --------------------------------------------------------------------- #

#: (B, S, H, Hkv, D, window, prefix_len) of the fp32 B3 rows, batch cut to
#: one: TinyLlama's full prefill (D 64, S 512), PaliGemma's image-prefix
#: prefill (D 256, prefix 256), hymba's window 2048 at its heads (one kv
#: head's 5 query heads, S 2,100 so the window cuts the last rows)
FLASH_ROWS = {
    "tinyllama_d64_s512": (1, 512, 32, 4, 64, 0, 0),
    "paligemma_d256_prefix256": (1, 512, 8, 1, 256, 0, 256),
    "hymba_window2048": (1, 2100, 5, 1, 64, 2048, 0),
    "d128_window_prefix": (1, 300, 8, 2, 128, 100, 40),
}


def _flash_case(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, S, H, D), _normal(rng, B, S, Hkv, D),
            _normal(rng, B, S, Hkv, D))


@pytest.mark.parametrize("name", list(FLASH_ROWS))
def test_b3_3xtf32_matches_the_jax_oracle(name):
    B, S, H, Hkv, D, window, prefix = FLASH_ROWS[name]
    arrs = _flash_case(21, B, S, H, Hkv, D)
    kw = dict(window=window, prefix_len=prefix)
    want = _jax_flash(arrs, **kw)
    got = flash_3xtf32(*map(torch.from_numpy, arrs), **kw)
    assert _beyond(got, want) == 0, (got - want).abs().max()


def test_b3_3xtf32_not_causal():
    arrs = _flash_case(22, 1, 200, 8, 2, 256)
    want = _jax_flash(arrs, causal=False)
    got = flash_3xtf32(*map(torch.from_numpy, arrs), causal=False)
    assert _beyond(got, want) == 0


# --------------------------------------------------------------------- #
# the control: one TF32 product does not keep the fp32 tolerance
# --------------------------------------------------------------------- #

def test_one_tf32_product_misses_the_fp32_tolerance_at_d256():
    arrs = _prefill_case(11, *PREFILL_ROWS["paligemma_d256"])
    want = _jax_prefill(arrs)
    t = list(map(torch.from_numpy, arrs))
    one, valid = prefill_3xtf32(*t, passes=1)
    three, _ = prefill_3xtf32(*t)
    assert _beyond(one[valid], want[valid]) > 1000
    assert _beyond(three[valid], want[valid]) == 0
    err1 = (one[valid] - want[valid]).abs().max()
    err3 = (three[valid] - want[valid]).abs().max()
    assert err1 > 10 * err3 and err1 > 2e-5
    B, S, H, Hkv, D, window, prefix = FLASH_ROWS["paligemma_d256_prefix256"]
    arrs = _flash_case(21, B, S, H, Hkv, D)
    want = _jax_flash(arrs, prefix_len=prefix)
    one = flash_3xtf32(*map(torch.from_numpy, arrs), prefix_len=prefix,
                       passes=1)
    assert _beyond(one, want) > 1000
