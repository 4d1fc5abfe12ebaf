"""Every family's training against the JAX package on the CPU: the port's
``train_loss`` value and every gradient leaf against
``jax.value_and_grad(repro.models.model.train_loss)`` for all ten assigned
architectures (reduced, fp32), with and without per-layer remat (a
non-reentrant checkpoint recomputes the layer and so hides an in-place
write into a tensor autograd saved), on both MoE dispatches, with an
expert past its capacity and with padding experts; the hybrid scan's
autograd function (``models.ssm.ChunkScan``) against a plain out-of-place
scan, and serving's no-grad SSM path bit for bit as it was; RWKV6
training on the closed chunked form, never on the forward-only WKV6
wrapper; and one AdamW step of ``make_train_step(moe_impl=...)`` against
JAX's.

Tolerances (fp32): the loss to ``rtol=1e-5`` and each gradient element
to ``GRAD_TOL`` (``rtol=5e-4, atol=5e-6``, as
``tests/test_torch_training.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.models import model as JM
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import init_adamw as jinit_adamw
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv_scan import ops as wkv_ops
from repro_torch.models import model as TM
from repro_torch.models import moe, ssm
from repro_torch.training import (AdamWConfig, init_adamw, make_loss_fn,
                                  make_train_step, value_and_grad)

from _torch_parity import np_of, params_pair, reduced_pair

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


def _batch(cfg, B=2, S=16, seed=3):
    """Tokens and labels (and a ``patch`` model's embeddings) from a seed."""
    rs = np.random.RandomState(seed)
    out = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "patch":
        out["patch_embeds"] = rs.randn(B, cfg.num_patches,
                                       cfg.d_model).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _assert_matches_jax(jcfg, tcfg, jp, tp, batch, **kw):
    """The port's loss and gradients equal JAX's ``train_loss``'s."""
    jloss, jgrads = jax.value_and_grad(lambda p: JM.train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, **kw))(jp)
    loss, grads = value_and_grad(make_loss_fn(tcfg, **kw))(
        tp, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    jg = dict(_named(jax.tree.map(np.asarray, jgrads)))
    tg = dict(_named(grads))
    assert set(tg) == set(jg)
    for name, g in tg.items():
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), jg[name], **GRAD_TOL,
                                   err_msg=name)


def _cases():
    for arch in ASSIGNED_ARCHS:
        impls = ("sparse", "dense") if get_config(arch).num_experts \
            else ("sparse",)
        for moe_impl in impls:
            for remat in (True, False):
                yield arch, remat, moe_impl


@pytest.mark.parametrize("arch,remat,moe_impl", list(_cases()))
def test_train_loss_and_grads_match_jax(arch, remat, moe_impl):
    jcfg, tcfg = reduced_pair(arch)
    TM.check_supported(tcfg, train=True)
    jp, tp = params_pair(jcfg)
    _assert_matches_jax(jcfg, tcfg, jp, tp, _batch(jcfg), remat=remat,
                        moe_impl=moe_impl)


# --------------------------------------------------------------------- #
# MoE: an expert past its capacity, padding experts
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("remat", [True, False])
def test_moe_capacity_overflow_trains_like_jax(arch, remat, monkeypatch):
    """The most-picked expert's router column scaled up 4x: the sparse
    dispatch drops (token, k) entries past an expert's capacity in every
    layer, in JAX's order, and the gradients follow the drops."""
    jcfg, tcfg = reduced_pair(arch)
    jp, tp = params_pair(jcfg)
    router = np.array(jp["layers"]["moe"]["router"])
    router[:, :, 2] *= 4.0
    jp["layers"]["moe"]["router"] = jnp.asarray(router)
    tp["layers"]["moe"]["router"] = torch.from_numpy(router)
    dropped = []
    slots = moe.dispatch_slots

    def spy(topi, E, C):
        row, keep = slots(topi, E, C)
        dropped.append(int((~keep).sum()))
        return row, keep

    monkeypatch.setattr(moe, "dispatch_slots", spy)
    _assert_matches_jax(jcfg, tcfg, jp, tp, _batch(jcfg), remat=remat,
                        moe_impl="sparse")
    assert len(dropped) >= tcfg.num_layers and min(dropped) > 0, dropped


@pytest.mark.parametrize("moe_impl", ["sparse", "dense"])
def test_moe_padding_experts_train_like_jax(moe_impl):
    """3 experts padded to 4: the padding expert is never picked and its
    weights get exact zero gradients, in both packages."""
    jcfg, tcfg = reduced_pair("qwen2-moe-a2.7b", num_experts=3)
    assert tcfg.padded_experts == 4 > tcfg.num_experts
    jp, tp = params_pair(jcfg)
    _assert_matches_jax(jcfg, tcfg, jp, tp, _batch(jcfg), moe_impl=moe_impl)
    _, grads = value_and_grad(make_loss_fn(tcfg, moe_impl=moe_impl))(
        tp, _torch_batch(_batch(jcfg)))
    for leaf in ("wi_gate", "wi_up", "wo"):
        assert not grads["layers"]["moe"][leaf][:, 3].any(), leaf


# --------------------------------------------------------------------- #
# the hybrid family's SSM scan
# --------------------------------------------------------------------- #

def _loop_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t, h_{-1} = 0, one step at a time, out of
    place: plain autograd differentiates it."""
    h, out = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("Q", [1, 2, 7, 16, 128])
def test_chunk_scan_grads_match_an_out_of_place_scan(Q):
    g = torch.Generator().manual_seed(Q)
    a = torch.rand((2, Q, 3, 4), generator=g).requires_grad_(True)
    b = torch.randn((2, Q, 3, 4), generator=g).requires_grad_(True)
    w = torch.randn((2, Q, 3, 4), generator=g)
    h = ssm.chunk_scan(a, b)
    da, db = torch.autograd.grad((h * w).sum(), (a, b))
    want = _loop_scan(a, b)
    ra, rb = torch.autograd.grad((want * w).sum(), (a, b))
    torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(db, rb, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(da, ra, rtol=1e-5, atol=1e-6)
    assert not da[:, 0].any()              # a_0 meets the zero state
    with torch.no_grad():                  # the forward's values, bit for bit
        assert torch.equal(h, ssm._ssm_core_scan(a.clone(), b.clone()))


def _ssm_inputs(cfg, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, cfg.d_model), generator=g) * 0.5
    state = {"h": torch.randn((B, cfg.d_inner, cfg.ssm_state), generator=g),
             "conv": torch.randn((B, ssm.CONV_K - 1, cfg.d_inner),
                                 generator=g)}
    return x, state


def test_apply_ssm_full_grads_match_an_out_of_place_scan(monkeypatch):
    """``apply_ssm_full`` under autograd, chunks of 8 over S = 21 (the
    last one ragged), continuing from a random state, on ragged
    ``length`` (a padded row, an empty row): the gradients of every
    leaf, the input and the carried state through ``ChunkScan`` equal
    those of the same function with the scan done out of place."""
    _, tcfg = reduced_pair("hymba-1.5b")
    params = {k: v[0] for k, v in
              TM.init_params(tcfg, 1, device="cpu")["layers"]["ssm"].items()}
    x, state = _ssm_inputs(tcfg, 3, 21, seed=5)
    length = torch.tensor([21, 13, 0])

    def grads():
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in {**params, "x": x, "h": state["h"]}.items()}
        p = {k: leaves[k] for k in params}
        y, st = ssm.apply_ssm_full(p, tcfg, leaves["x"], chunk=8,
                                   state={"h": leaves["h"],
                                          "conv": state["conv"]},
                                   length=length)
        w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        loss = (y * w).sum() + (st["h"] ** 2).sum()
        return y.detach(), dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))

    y, got = grads()
    monkeypatch.setattr(ssm, "chunk_scan", _loop_scan)
    y_ref, want = grads()
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-6)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


def _parent_apply_ssm_full(params, cfg, x, chunk, state, length):
    """``apply_ssm_full`` as it was before the scan had a backward: the
    carry injected and the doubling scan run in place.  Serving's no-grad
    path must stay bit-equal to it."""
    B, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    xz = x @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)
    stream = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)
    idx = (length.long()[:, None]
           + torch.arange(ssm.CONV_K - 1)[None, :])
    new_conv = torch.take_along_dim(
        stream, idx[:, :, None].expand(B, ssm.CONV_K - 1, di), dim=1)
    xin = torch.nn.functional.silu(ssm._conv_window(stream,
                                                     params["conv_w"], S))
    dt = torch.nn.functional.softplus((xin @ params["dt_proj"]).float()
                                      + params["dt_bias"].float())
    valid = torch.arange(S)[None, :] < length[:, None]
    dt = torch.where(valid[..., None], dt, 0.0)
    Bt, Ct = torch.chunk((xin @ params["bc_proj"]).float(), 2, dim=-1)
    A = -torch.exp(params["A_log"])
    xf = xin.float()
    h, ys = state["h"], []
    for t0 in range(0, S, chunk):
        sl = slice(t0, min(t0 + chunk, S))
        dt_q = dt[:, sl]
        a = torch.exp(dt_q[..., None] * A)
        b = (dt_q * xf[:, sl])[..., None] * Bt[:, sl, None, :]
        b[:, 0] += a[:, 0] * h
        Q, s = a.shape[1], 1
        while s < Q:
            b[:, s:] += a[:, s:] * b[:, :Q - s]
            if 2 * s < Q:
                a[:, s:] = a[:, s:] * a[:, :Q - s]
            s *= 2
        ys.append(torch.einsum("bqdn,bqn->bqd", b, Ct[:, sl]))
        h = b[:, -1]
    y = torch.cat(ys, dim=1) + params["D"] * xf
    y = y.to(x.dtype) * torch.nn.functional.silu(z)
    return y @ params["out_proj"], {"h": h, "conv": new_conv}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_grad_apply_ssm_full_is_bit_equal_to_the_in_place_scan(dtype):
    """Serving's path (no gradient recorded) is the in-place scan, bit for
    bit, and the training forward computes the same bits."""
    _, tcfg = reduced_pair("hymba-1.5b", dtype=dtype)
    params = {k: v[0] for k, v in
              TM.init_params(tcfg, 2, device="cpu")["layers"]["ssm"].items()}
    x, state = _ssm_inputs(tcfg, 3, 21, seed=6)
    x, state["conv"] = x.to(params["in_proj"].dtype), \
        state["conv"].to(params["in_proj"].dtype)
    length = torch.tensor([21, 13, 0])
    with torch.no_grad():
        y, st = ssm.apply_ssm_full(params, tcfg, x, chunk=8, state=state,
                                   length=length)
        y0, st0 = _parent_apply_ssm_full(params, tcfg, x, 8, state, length)
    assert torch.equal(y, y0)
    for k in st0:
        assert torch.equal(st[k], st0[k]), k
    leaf = params["dt_proj"].clone().requires_grad_(True)
    yg, stg = ssm.apply_ssm_full({**params, "dt_proj": leaf}, tcfg, x,
                                 chunk=8, state=state, length=length)
    assert yg.requires_grad and torch.equal(yg.detach(), y0)
    assert torch.equal(stg["h"].detach(), st0["h"])


def test_hybrid_trains_across_ssm_chunks_like_jax():
    """S = 160 is longer than the SSM's chunk of 128, so the carry crosses
    a chunk boundary under autograd (JAX cuts 5 chunks of 32, the port
    128 + 32: the same recurrence)."""
    jcfg, tcfg = reduced_pair("hymba-1.5b")
    jp, tp = params_pair(jcfg)
    _assert_matches_jax(jcfg, tcfg, jp, tp, _batch(jcfg, B=1, S=160))


# --------------------------------------------------------------------- #
# RWKV6 trains on the chunked form; B4's wrapper only serves
# --------------------------------------------------------------------- #

def test_rwkv_training_never_reaches_the_wkv6_wrapper(monkeypatch):
    jcfg, tcfg = reduced_pair("rwkv6-7b")
    _, tp = params_pair(jcfg)
    calls = []
    wkv6 = wkv_ops.wkv6

    def counted(*a, **kw):
        calls.append(1)
        return wkv6(*a, **kw)

    monkeypatch.setattr(wkv_ops, "wkv6", counted)
    batch = _torch_batch(_batch(jcfg, S=128))
    loss, grads = value_and_grad(make_loss_fn(tcfg))(tp, batch)
    assert calls == [] and torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for _, g in _named(grads))
    with torch.no_grad():                   # serving still goes through it
        logits, _ = TM.prefill(tcfg, tp, {"tokens": batch["tokens"]}, 128)
    assert len(calls) == tcfg.num_layers and torch.isfinite(logits).all()


def test_rwkv_time_mix_scans_agree_and_unknown_scan_raises():
    _, tcfg = reduced_pair("rwkv6-7b")
    lp = {k: v[0] for k, v in
          TM.init_params(tcfg, 4, device="cpu")["layers"].items()}
    from repro_torch.models import rwkv
    x = torch.randn((2, 32, tcfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    st = rwkv.init_rwkv_state(tcfg, 2, device="cpu")
    yk, sk = rwkv.rwkv_time_mix_full(lp, tcfg, x, st)
    yc, sc = rwkv.rwkv_time_mix_full(lp, tcfg, x, st, scan="chunked")
    torch.testing.assert_close(yc, yk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sc["S"], sk["S"], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown scan"):
        rwkv.rwkv_time_mix_full(lp, tcfg, x, st, scan="loop")


def _wkv_inputs(seed, B=1, S=128, H=2, D=8, w_lo=0.37, w_hi=0.42):
    """Decays at the strong end of RWKV6's range (w >= exp(-1) at init):
    over a 64-step chunk the cumulative decay W falls to ~1e-26, so
    W ** 2 underflows fp32."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, D), generator=g) for _ in range(3))
    w = w_lo + (w_hi - w_lo) * torch.rand((B, S, H, D), generator=g)
    u = torch.randn((H, D), generator=g) * 0.5
    return r, k, v, w, u


def test_log_quotients_keep_the_wkv6_backward_finite():
    """The training form's values and gradients against float64 autograd
    through the per-token recurrence, each within 1e-5 of the tensor's
    largest magnitude; the direct form (JAX's arithmetic) gives the same
    values but non-finite gradients here."""
    from repro_torch.kernels.rwkv_scan import ref as wref
    r, k, v, w, u = _wkv_inputs(7)
    wt = torch.linspace(-1, 1, r.numel()).reshape(r.shape)

    def grads(fn, dtype, **kw):
        leaves = [t.to(dtype).requires_grad_(True) for t in (r, k, v, w, u)]
        B, _, H, D = r.shape
        y, S = fn(*leaves, torch.zeros((B, H, D, D), dtype=dtype), **kw)
        loss = (y * wt.to(dtype)).sum() + S.square().sum() * 1e-3
        return y.detach(), torch.autograd.grad(loss, leaves)

    y64, g64 = grads(wref.wkv6_reference, torch.float64)
    y, g = grads(wref.wkv6_chunked_ref, torch.float32, chunk=64,
                 log_quotients=True)
    y_direct, g_direct = grads(wref.wkv6_chunked_ref, torch.float32,
                               chunk=64)
    def near(a, b):
        return float((a.double() - b).abs().max()) <= 1e-5 * float(
            b.abs().max())

    assert near(y, y64) and near(y_direct, y64)
    for name, a, b in zip("rkvwu", g, g64):
        assert torch.isfinite(a).all() and near(a, b), name
    assert not torch.isfinite(g_direct[3]).all()        # dL/dw


def test_rwkv_trains_where_jax_gradients_turn_nan():
    """Every channel's decay base at -0.5 (stronger than the init's -6 ..
    -1), S = 128: JAX's ``train_loss`` gradient has NaNs (its W_s ** 2
    underflows); the port's loss equals JAX's and its gradients are
    finite."""
    jcfg, tcfg = reduced_pair("rwkv6-7b")
    jp, tp = params_pair(jcfg)
    base = np.full(np.asarray(jp["layers"]["decay_base"]).shape, -0.5,
                   np.float32)
    jp["layers"]["decay_base"] = jnp.asarray(base)
    tp["layers"]["decay_base"] = torch.from_numpy(base)
    batch = _batch(jcfg, S=128)
    jloss, jgrads = jax.value_and_grad(lambda p: JM.train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    loss, grads = value_and_grad(make_loss_fn(tcfg))(tp, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jgrads))
    for name, g in _named(grads):
        assert torch.isfinite(g).all(), name


# --------------------------------------------------------------------- #
# the train step takes JAX's moe_impl
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("moe_impl", ["sparse", "dense"])
def test_train_step_moe_impl_matches_jax(moe_impl):
    """One AdamW step of ``make_train_step(moe_impl=...)`` in both
    packages on reduced qwen3-moe: the loss, the grad norm and every new
    parameter."""
    jcfg, tcfg = reduced_pair("qwen3-moe-30b-a3b")
    jp, tp = params_pair(jcfg)
    batch = _batch(jcfg, S=8)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(lr=1e-3),
                                     moe_impl=moe_impl))
    jnew, _, jm = jstep(jp, jinit_adamw(jp),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(tcfg, AdamWConfig(lr=1e-3), moe_impl=moe_impl)
    new, _, m = step(tp, init_adamw(tp), _torch_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    jn = dict(_named(jax.tree.map(np.asarray, jnew)))
    for name, p in _named(new):
        np.testing.assert_allclose(np_of(p), jn[name], rtol=1e-5, atol=2e-6,
                                   err_msg=name)
