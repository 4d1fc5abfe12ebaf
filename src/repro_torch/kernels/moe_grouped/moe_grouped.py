"""Hand-written Hopper kernels (Triton) for the dropless grouped MoE
dispatch: ``moe_grouped_cuda``.

They replace no TPU kernel: the JAX package computes its MoE layer with
XLA's dense or capacity-buffer products.  They exist because neither
dispatch serves 128 experts at top-8: the dense one runs every expert on
every token (16x the routed work), the capacity one drops tokens.  Five
kernels, launched in order on the current stream, with no host sync, so a
step graph captures them:

* ``moe_grouped_route``: the router's logits (a float32 sum over d,
  rounded to the activations' dtype as a ``torch.matmul`` output is),
  the padding experts masked, the top K by repeated maxima (the lower
  expert first among equal logits), softmaxed in float32; an inert token
  (``valid`` false) routes to expert ``E``, which is none.  A block of
  tokens with no live one reads no weight.
* ``moe_grouped_layout``: one program an expert counts the rows routed to
  it and to lower experts (its start), then writes the flat (token, k)
  indices of its rows, in order, at its start: a stable counting sort,
  no atomics.  It also adds its count to the layer's row accumulators.
* ``moe_grouped_mm_gate_up`` and ``moe_grouped_mm_down``: the grouped
  products over blocks of ``BM`` rows of one expert.  Expert e's blocks
  are numbered from ``start_e // BM + e``, which needs no other expert's
  count and never overlaps the next expert's; a program finds its expert
  from the starts and leaves at once where its block holds no row, so the
  grid is sized for the call's T alone.  The first reads the rows of x it
  needs by their token index (no gathered copy) and writes ``silu(g) *
  u`` in the dtype, in expert order; the second reads those rows and
  writes each output row at its (token, k) index.  Both read the stacked
  ``(E, d, f)`` / ``(E, f, d)`` weights in place.
* ``moe_grouped_combine``: each token's K rows, each times its weight
  rounded to the dtype, summed in k order in the dtype (the dense
  dispatch's rounding points); an inert token's output is zero.

What bounds them: a decode step's 128 tokens route 1,024 rows, so nearly
every expert is read for 8 rows, and the products are bound by reading
the weights (1.21 GB a layer at Qwen3-30B-A3B's widths) at the card's
3.35 TB/s; a prefill round of a few thousand tokens is near the ridge.
The design streams each weight tile once per block of 64 rows, with the
blocks of one expert's tile launched side by side so that a second block
finds the tile in L2, and a K-loop pipelined ``NUM_STAGES`` deep.

In float32 each product is three TF32 products (3xTF32, as B2 and B3
take float32), on the tensor cores: a float32 dot on the CUDA cores
takes ~100x the bf16 layer's time at these widths.

Every sum over d or f runs in one fixed order, with one block shape for
every call: a row's output does not depend on the other rows of the call
(no split-K, no atomics), so a row gives the same bits alone, in a
packed prefill grid, and in a graph's replay.  ``moe_grouped_cuda``
counts its calls in ``launches`` (five kernels each).  Triton is imported,
and the kernels built, at the first call: this module imports on a host
with no Triton.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

BM = 64            # routed rows a block of the grouped products
BN_UP = 64         # f columns a gate/up program
BK = 64            # depth a step of the products' K-loop
ROUTE_BT = 16      # tokens a route program
SCAN = 1024        # ids a layout program reads at a time
COMBINE_BT = 16    # tokens a combine program
COMBINE_BD = 256   # d columns a combine program
NUM_STAGES = 4
NUM_WARPS = 4

DTYPES = (torch.bfloat16, torch.float32)


def _pow2(n: int) -> int:
    return max(16, 1 << (n - 1).bit_length())


def bn_down(d: int) -> int:
    """The d columns a down program computes (a function of the shape)."""
    return 128 if d % 128 == 0 else 64


@functools.lru_cache(maxsize=1)
def kernels():
    """Build the five Triton kernels (first call only)."""
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["T"])
    def moe_grouped_route(x_ptr, w_ptr, valid_ptr, ids_ptr, wts_ptr, T,
                          D: tl.constexpr, E: tl.constexpr,
                          E_REAL: tl.constexpr, EP: tl.constexpr,
                          K: tl.constexpr, KP: tl.constexpr,
                          BT: tl.constexpr, BKR: tl.constexpr,
                          HAS_VALID: tl.constexpr, OUT: tl.constexpr,
                          PREC: tl.constexpr):
        pid = tl.program_id(0)
        t = pid * BT + tl.arange(0, BT)
        live = t < T
        if HAS_VALID:  # repro: allow-recompile-hazard(a Triton constexpr: one compiled variant a value, fixed by the call)
            live = live & (tl.load(valid_ptr + t, mask=t < T, other=0) != 0)
        n_live = tl.sum(live.to(tl.int32), 0)
        cols = tl.arange(0, EP)
        kk = tl.arange(0, BKR)
        acc = tl.zeros((BT, EP), dtype=tl.float32)
        hi = tl.where(n_live > 0, D, 0)         # no live token: no reads
        for k0 in range(0, hi, BKR):
            a = tl.load(x_ptr + t.to(tl.int64)[:, None] * D
                        + (k0 + kk)[None, :], mask=live[:, None], other=0.0)
            b = tl.load(w_ptr + (k0 + kk)[:, None] * E + cols[None, :],
                        mask=(cols < E)[None, :], other=0.0)
            acc = tl.dot(a, b, acc, input_precision=PREC)
        logits = acc.to(OUT).to(tl.float32)
        logits = tl.where((cols < E_REAL)[None, :], logits, -1e30)
        logits = tl.where((cols < E)[None, :], logits, float("-inf"))
        kc = tl.arange(0, KP)
        vals = tl.full((BT, KP), float("-inf"), dtype=tl.float32)
        ids = tl.zeros((BT, KP), dtype=tl.int32)
        for k in tl.static_range(K):
            m = tl.max(logits, axis=1)
            idx = tl.min(tl.where(logits == m[:, None], cols[None, :], EP),
                         axis=1)
            vals = tl.where(kc[None, :] == k, m[:, None], vals)
            ids = tl.where(kc[None, :] == k, idx[:, None], ids)
            logits = tl.where(cols[None, :] == idx[:, None], float("-inf"),
                              logits)
        ex = tl.exp(vals - tl.max(vals, axis=1)[:, None])  # 0 past K
        wts = ex / tl.sum(ex, axis=1)[:, None]
        ids = tl.where(live[:, None], ids, E)
        out = t[:, None] * K + kc[None, :]
        keep = (t < T)[:, None] & (kc < K)[None, :]
        tl.store(ids_ptr + out, ids, mask=keep)
        tl.store(wts_ptr + out, wts, mask=keep)

    @triton.jit(do_not_specialize=["TK"])
    def moe_grouped_layout(ids_ptr, rows_ptr, seg_ptr, stats_ptr, TK,
                           E: tl.constexpr, E_REAL: tl.constexpr,
                           CH: tl.constexpr, HAS_STATS: tl.constexpr):
        e = tl.program_id(0)
        offs = tl.arange(0, CH)
        n_lt = 0
        n_eq = 0
        n_all = 0
        for s in range(0, TK, CH):
            i = s + offs
            v = tl.load(ids_ptr + i, mask=i < TK, other=E)
            n_lt += tl.sum((v < e).to(tl.int32), 0)
            n_eq += tl.sum((v == e).to(tl.int32), 0)
            n_all += tl.sum((v < E).to(tl.int32), 0)
        tl.store(seg_ptr + e, n_lt)
        tl.store(seg_ptr + E + e, n_eq)
        run = 0
        hi = tl.where(n_eq > 0, TK, 0)
        for s in range(0, hi, CH):
            i = s + offs
            v = tl.load(ids_ptr + i, mask=i < TK, other=E)
            hit = (v == e).to(tl.int32)
            r = n_lt + run + tl.cumsum(hit, 0) - 1
            tl.store(rows_ptr + r, i, mask=hit != 0)
            run += tl.sum(hit, 0)
        if HAS_STATS:  # repro: allow-recompile-hazard(a Triton constexpr: one compiled variant a value, fixed by the call)
            tl.store(stats_ptr + e, tl.load(stats_ptr + e) + n_eq)
            tl.store(stats_ptr + E + e, tl.load(stats_ptr + E + e)
                     + (n_eq > 0).to(tl.int64))
            if e == 0:
                tl.store(stats_ptr + 2 * E, tl.load(stats_ptr + 2 * E)
                         + tl.minimum(n_all, E_REAL))

    @triton.jit
    def _block(seg_ptr, b, E: tl.constexpr, EP: tl.constexpr,
               BMB: tl.constexpr):
        """(expert, first sorted row, rows) of block ``b``; rows <= 0 where
        the block holds none."""
        es = tl.arange(0, EP)
        st = tl.load(seg_ptr + es, mask=es < E, other=0)
        base = tl.where(es < E, st // BMB + es, 2147483647)
        e = tl.sum((base <= b).to(tl.int32), 0) - 1
        e = tl.maximum(e, 0)
        start = tl.load(seg_ptr + e)
        cnt = tl.load(seg_ptr + E + e)
        j = b - (start // BMB + e)
        return e, start + j * BMB, tl.minimum(cnt - j * BMB, BMB)

    @triton.jit(do_not_specialize=["NB"])
    def moe_grouped_mm_gate_up(x_ptr, rows_ptr, seg_ptr, wg_ptr, wu_ptr,
                               h_ptr, NB, D: tl.constexpr, F: tl.constexpr,
                               E: tl.constexpr, EP: tl.constexpr,
                               K: tl.constexpr, BMB: tl.constexpr,
                               BN: tl.constexpr, BKK: tl.constexpr,
                               OUT: tl.constexpr, PREC: tl.constexpr):
        pid = tl.program_id(0)
        b = pid % NB
        n = pid // NB
        e, r0, nrows = _block(seg_ptr, b, E, EP, BMB)
        if nrows <= 0:
            return
        i = tl.arange(0, BMB)
        rmask = i < nrows
        tok = tl.load(rows_ptr + r0 + i, mask=rmask, other=0) // K
        cols = n * BN + tl.arange(0, BN)
        kk = tl.arange(0, BKK)
        a_ptrs = x_ptr + tok.to(tl.int64)[:, None] * D + kk[None, :]
        w_off = e.to(tl.int64) * D * F + kk[:, None] * F + cols[None, :]
        g_ptrs = wg_ptr + w_off
        u_ptrs = wu_ptr + w_off
        acc_g = tl.zeros((BMB, BN), dtype=tl.float32)
        acc_u = tl.zeros((BMB, BN), dtype=tl.float32)
        for _ in range(0, D, BKK):
            a = tl.load(a_ptrs, mask=rmask[:, None], other=0.0)
            bg = tl.load(g_ptrs)
            bu = tl.load(u_ptrs)
            acc_g = tl.dot(a, bg, acc_g, input_precision=PREC)
            acc_u = tl.dot(a, bu, acc_u, input_precision=PREC)
            a_ptrs += BKK
            g_ptrs += BKK * F
            u_ptrs += BKK * F
        g = acc_g.to(OUT).to(tl.float32)
        u = acc_u.to(OUT).to(tl.float32)
        s = (g / (1.0 + tl.exp(-g))).to(OUT).to(tl.float32)
        h = (s * u).to(OUT)
        tl.store(h_ptr + (r0 + i).to(tl.int64)[:, None] * F + cols[None, :],
                 h, mask=rmask[:, None])

    @triton.jit(do_not_specialize=["NB"])
    def moe_grouped_mm_down(h_ptr, rows_ptr, seg_ptr, wo_ptr, out_ptr, NB,
                            D: tl.constexpr, F: tl.constexpr,
                            E: tl.constexpr, EP: tl.constexpr,
                            BMB: tl.constexpr, BN: tl.constexpr,
                            BKK: tl.constexpr, OUT: tl.constexpr,
                            PREC: tl.constexpr):
        pid = tl.program_id(0)
        b = pid % NB
        n = pid // NB
        e, r0, nrows = _block(seg_ptr, b, E, EP, BMB)
        if nrows <= 0:
            return
        i = tl.arange(0, BMB)
        rmask = i < nrows
        cols = n * BN + tl.arange(0, BN)
        kk = tl.arange(0, BKK)
        a_ptrs = h_ptr + (r0 + i).to(tl.int64)[:, None] * F + kk[None, :]
        w_ptrs = wo_ptr + e.to(tl.int64) * F * D + kk[:, None] * D \
            + cols[None, :]
        acc = tl.zeros((BMB, BN), dtype=tl.float32)
        for _ in range(0, F, BKK):
            a = tl.load(a_ptrs, mask=rmask[:, None], other=0.0)
            w = tl.load(w_ptrs)
            acc = tl.dot(a, w, acc, input_precision=PREC)
            a_ptrs += BKK
            w_ptrs += BKK * D
        row = tl.load(rows_ptr + r0 + i, mask=rmask, other=0)
        tl.store(out_ptr + row.to(tl.int64)[:, None] * D + cols[None, :],
                 acc.to(OUT), mask=rmask[:, None])

    @triton.jit(do_not_specialize=["T"])
    def moe_grouped_combine(out_ptr, ids_ptr, wts_ptr, y_ptr, T,
                            D: tl.constexpr, E: tl.constexpr,
                            K: tl.constexpr, BT: tl.constexpr,
                            BD: tl.constexpr, OUT: tl.constexpr):
        t = tl.program_id(0) * BT + tl.arange(0, BT)
        c = tl.program_id(1) * BD + tl.arange(0, BD)
        tm = t < T
        cm = c < D
        y = tl.zeros((BT, BD), dtype=tl.float32)
        for k in tl.static_range(K):
            r = t * K + k
            live = tm & (tl.load(ids_ptr + r, mask=tm, other=E) < E)
            w = tl.load(wts_ptr + r, mask=tm, other=0.0).to(OUT)
            o = tl.load(out_ptr + r.to(tl.int64)[:, None] * D + c[None, :],
                        mask=live[:, None] & cm[None, :], other=0.0)
            p = (o.to(tl.float32) * w.to(tl.float32)[:, None]).to(OUT)
            if k == 0:
                y = p.to(tl.float32)
            else:
                y = (y + p.to(tl.float32)).to(OUT).to(tl.float32)
        tl.store(y_ptr + t.to(tl.int64)[:, None] * D + c[None, :],
                 y.to(OUT), mask=tm[:, None] & cm[None, :])

    return (moe_grouped_route, moe_grouped_layout, moe_grouped_mm_gate_up,
            moe_grouped_mm_down, moe_grouped_combine,
            {torch.bfloat16: tl.bfloat16, torch.float32: tl.float32})


def _check(name: str, t: torch.Tensor, dtype, dim: int) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or t.dim() != dim \
            or not t.is_contiguous():
        raise ValueError(f"moe_grouped_cuda: {name} must be a contiguous "
                         f"{dim}-d CUDA {dtype} tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def moe_grouped_cuda(xt: torch.Tensor, router: torch.Tensor,
                     wi_gate: torch.Tensor, wi_up: torch.Tensor,
                     wo: torch.Tensor, *, top_k: int, num_experts: int,
                     valid: Optional[torch.Tensor] = None,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xt (T, d); router (d, E); wi_gate / wi_up (E, d, f); wo (E, f, d),
    all of xt's dtype (bfloat16 or float32); valid (T,) bool or None;
    stats (2E + 2,) int64 accumulators or None (``ref.count_rows``) ->
    (T, d).  Raises on what the kernels do not take."""
    dtype = xt.dtype
    if dtype not in DTYPES:
        raise ValueError(f"moe_grouped_cuda: dtype {dtype} (bfloat16 or "
                         "float32)")
    _check("xt", xt, dtype, 2)
    _check("router", router, dtype, 2)
    for name, w in (("wi_gate", wi_gate), ("wi_up", wi_up), ("wo", wo)):
        _check(name, w, dtype, 3)
    T, d = xt.shape
    E, _, f = wi_gate.shape
    K = int(top_k)
    if router.shape != (d, E) or wi_up.shape != (E, d, f) \
            or wo.shape != (E, f, d):
        raise ValueError("moe_grouped_cuda: router (d, E), wi_gate / wi_up "
                         "(E, d, f) and wo (E, f, d) must agree")
    if d % 64 or f % BN_UP or not 0 < K <= num_experts <= E:
        raise ValueError(f"moe_grouped_cuda: d {d} and f {f} must be "
                         f"multiples of 64, 0 < K {K} <= {num_experts} <= "
                         f"{E}")
    if valid is not None:
        _check("valid", valid, torch.bool, 1)
    if stats is not None:
        _check("stats", stats, torch.int64, 1)
        if stats.shape[0] != 2 * E + 2:
            raise ValueError("moe_grouped_cuda: stats must be (2E + 2,)")
    route, layout, gate_up, down, combine, tl_dtype = kernels()
    dev = xt.device
    # float32 products as three TF32 products each (3xTF32, as B2 and B3
    # take fp32): float32's accuracy on the tensor cores
    out_dt = tl_dtype[dtype]
    prec = "tf32x3" if dtype == torch.float32 else None
    TK = T * K
    NB = -(-TK // BM) + E               # blocks: sum of ceil(n_e / BM)
    EP = _pow2(E)
    ids = torch.empty((T, K), dtype=torch.int32, device=dev)
    wts = torch.empty((T, K), dtype=torch.float32, device=dev)
    seg = torch.empty((2, E), dtype=torch.int32, device=dev)
    rows = torch.empty((max(TK, 1),), dtype=torch.int32, device=dev)
    h = torch.empty((max(TK, 1), f), dtype=dtype, device=dev)
    out = torch.empty((max(TK, 1), d), dtype=dtype, device=dev)
    y = torch.empty((T, d), dtype=dtype, device=dev)
    if T == 0:
        return y
    route[(-(-T // ROUTE_BT),)](
        xt, router, valid if valid is not None else xt, ids, wts, T,
        D=d, E=E, E_REAL=num_experts, EP=EP, K=K, KP=_pow2(K), BT=ROUTE_BT,
        BKR=64, HAS_VALID=valid is not None, OUT=out_dt, PREC=prec,
        num_warps=4)
    layout[(E,)](ids, rows, seg, stats if stats is not None else ids, TK,
                 E=E, E_REAL=num_experts, CH=SCAN,
                 HAS_STATS=stats is not None, num_warps=8)
    gate_up[(NB * (f // BN_UP),)](
        xt, rows, seg, wi_gate, wi_up, h, NB, D=d, F=f, E=E, EP=EP, K=K,
        BMB=BM, BN=BN_UP, BKK=BK, OUT=out_dt, PREC=prec,
        num_warps=NUM_WARPS, num_stages=NUM_STAGES)
    bn = bn_down(d)
    down[(NB * (d // bn),)](
        h, rows, seg, wo, out, NB, D=d, F=f, E=E, EP=EP, BMB=BM, BN=bn,
        BKK=BK, OUT=out_dt, PREC=prec,
        num_warps=NUM_WARPS, num_stages=NUM_STAGES)
    combine[(-(-T // COMBINE_BT), -(-d // COMBINE_BD))](
        out, ids, wts, y, T, D=d, E=E, K=K, BT=COMBINE_BT,
        BD=min(COMBINE_BD, d), OUT=out_dt, num_warps=4)
    moe_grouped_cuda.launches += 1
    return y


moe_grouped_cuda.launches = 0
