"""The port's plain WKV6 versions (``repro_torch.kernels.rwkv_scan.ref``)
and its device-dispatched entry ``ops.wkv6`` against the JAX package on
the CPU: the Pallas kernel ``repro.kernels.rwkv_scan.ops.wkv6`` in
interpret mode (as ``tests/test_kernels.py`` runs it) and the oracle
``repro.kernels.rwkv_scan.ref.wkv6_reference`` (with an initial state).
Inputs are made with numpy from a stated seed and handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.ops import wkv6 as j_wkv6
from repro.kernels.rwkv_scan.ref import wkv6_reference as j_reference
from repro_torch.kernels import NoBackwardError
from repro_torch.kernels.rwkv_scan import ops as TO
from repro_torch.kernels.rwkv_scan import ref as TR
from repro_torch.models.ssm import pick_chunk

torch.set_num_threads(2)

#: tests/test_kernels.py's tolerances: 3e-5, and 1e-4 at the decay extremes
TOL = dict(rtol=3e-5, atol=3e-5)
TOL_EXTREME = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, S, H, D, wval=None, s0=False):
    """tests/test_kernels.py's distributions, from numpy: r, k, v ~
    0.3 N(0, 1), w = 0.5 sigmoid(N(0, 1)) + 0.45, u ~ 0.1 N(0, 1);
    ``wval`` a constant decay (u = 0); ``s0`` a random initial state."""
    rs = np.random.RandomState(seed)
    r, k, v = (0.3 * rs.randn(B, S, H, D).astype(np.float32)
               for _ in range(3))
    if wval is None:
        w = 0.5 / (1.0 + np.exp(-rs.randn(B, S, H, D))) + 0.45
        u = 0.1 * rs.randn(H, D)
    else:
        w = np.full((B, S, H, D), wval)
        u = np.zeros((H, D))
    st = rs.randn(B, H, D, D).astype(np.float32) if s0 else None
    return (r, k, v, w.astype(np.float32), u.astype(np.float32), st)


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


SWEEP = [(1, 64, 2, 32, 16), (2, 128, 4, 32, 64), (1, 96, 2, 64, 32),
         (2, 64, 2, 32, 64)]                  # tests/test_kernels.py:144-149


@pytest.mark.parametrize("B,S,H,D,chunk", SWEEP)
def test_plain_versions_match_the_pallas_kernel(B, S, H, D, chunk):
    r, k, v, w, u, _ = _inputs(0, B, S, H, D)
    jy, js = j_wkv6(*map(jnp.asarray, (r, k, v, w, u)), chunk=chunk)
    for y, s in (TR.wkv6_chunked_ref(*_t(r, k, v, w, u), None, chunk),
                 TR.wkv6_reference(*_t(r, k, v, w, u))):
        _close(y, jy, TOL)
        _close(s, js, TOL)


@pytest.mark.parametrize("wval", [0.01, 0.999])
def test_plain_versions_at_the_decay_extremes(wval):
    """w near 0 (full reset) and near 1 (full memory) stay stable."""
    r, k, v, w, u, _ = _inputs(1, 1, 64, 2, 32, wval=wval)
    jy, js = j_wkv6(*map(jnp.asarray, (r, k, v, w, u)), chunk=16)
    for y, s in (TR.wkv6_chunked_ref(*_t(r, k, v, w, u), None, 16),
                 TR.wkv6_reference(*_t(r, k, v, w, u))):
        _close(y, jy, TOL_EXTREME)
        _close(s, js, TOL_EXTREME)


@pytest.mark.parametrize("S", [37, 200, 127, 64])
def test_initial_state_matches_the_jax_oracle(S):
    """A random nonzero s0 (the engine's carried state; the TPU kernel
    has none), over pick_chunk's chunks: 37, 8, 1 and 64 steps."""
    r, k, v, w, u, s0 = _inputs(2, 2, S, 3, 16, s0=True)
    jy, js = j_reference(*map(jnp.asarray, (r, k, v, w, u, s0)))
    chunk = pick_chunk(S, 64)
    for y, s in (TR.wkv6_chunked_ref(*_t(r, k, v, w, u, s0), chunk),
                 TR.wkv6_reference(*_t(r, k, v, w, u, s0))):
        _close(y, jy, TOL)
        _close(s, js, TOL)


def test_padded_steps_leave_the_state_unchanged():
    """w = 1, k = 0 is the recurrence's identity: bit for bit per token,
    and in the chunked form for whole padded chunks (to 3e-5 otherwise,
    where padding changes the chunk factorization)."""
    r, k, v, w, u, s0 = _t(*_inputs(3, 2, 24, 3, 16, s0=True))

    def pad(t, val, n):
        return torch.cat([t, torch.full_like(t[:, :n], val)], dim=1)

    for n, chunk, exact in ((8, 8, True), (4, 4, True), (8, 32, False)):
        padded = (pad(r, 0.5, n), pad(k, 0.0, n), pad(v, 0.7, n),
                  pad(w, 1.0, n), u, s0)
        y, s = TR.wkv6_reference(r, k, v, w, u, s0)
        yp, sp = TR.wkv6_reference(*padded)
        assert torch.equal(sp, s) and torch.equal(yp[:, :24], y)
        y, s = TR.wkv6_chunked_ref(r, k, v, w, u, s0, pick_chunk(24, chunk))
        yp, sp = TR.wkv6_chunked_ref(*padded, chunk)
        if exact:
            assert torch.equal(sp, s)
        torch.testing.assert_close(sp, s, **TOL)
        torch.testing.assert_close(yp[:, :24], y, **TOL)


def test_chunked_form_refuses_a_chunk_that_does_not_divide():
    r, k, v, w, u, _ = _t(*_inputs(4, 1, 12, 1, 8))
    with pytest.raises(ValueError, match="does not divide"):
        TR.wkv6_chunked_ref(r, k, v, w, u, None, 5)


def test_ops_on_cpu_is_the_plain_chunked_form():
    r, k, v, w, u, s0 = _t(*_inputs(5, 2, 48, 2, 16, s0=True))
    y, s = TO.wkv6(r, k, v, w, u, s0=s0, chunk=16)
    wy, ws = TR.wkv6_chunked_ref(r, k, v, w, u, s0, 16)
    assert torch.equal(y, wy) and torch.equal(s, ws)
    y, s = TO.wkv6(r.double(), k, v, w, u, chunk=48)     # cast to fp32
    assert y.dtype == s.dtype == torch.float32


def test_ops_has_no_backward():
    r, k, v, w, u, _ = _t(*_inputs(6, 1, 16, 2, 8))
    r.requires_grad_(True)
    y, _ = TO.wkv6(r, k, v, w, u, chunk=16)
    with pytest.raises(NoBackwardError, match="forward-only"):
        y.sum().backward()
    assert TO.NoBackwardError is NoBackwardError
    assert not issubclass(NoBackwardError, RuntimeError)   # not retried
