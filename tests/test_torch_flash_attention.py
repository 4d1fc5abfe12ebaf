"""The port's full-sequence flash attention on the CPU (its plain PyTorch
version) against the JAX package: the Pallas kernel's wrapper
``repro.kernels.flash_attention.ops.flash_attention`` in interpret mode
and its oracle ``attention_reference``, over the sweep and options of
``tests/test_kernels.py``; the forward-only contract; the device
dispatch.  The CUDA kernel itself is held against the plain version on a
card by ``test_torch_cuda_kernels.py``.

Inputs are made with numpy from a seed and fed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as JO
from repro.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.flash_attention import flash_attention as TK
from repro_torch.kernels.flash_attention import ops as TO
from repro_torch.kernels.flash_attention import ref as TR

from _torch_parity import np_of

torch.set_num_threads(2)


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B, S, H, Hkv, D):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, H, D).astype(np.float32),
            rs.randn(B, S, Hkv, D).astype(np.float32),
            rs.randn(B, S, Hkv, D).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 4, 4, 64),       # MHA
    (2, 256, 8, 2, 64),       # GQA 4:1
    (1, 128, 8, 1, 128),      # MQA
    (2, 100, 4, 2, 64),       # ragged S
    (1, 512, 2, 2, 128),      # long
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep_matches_jax(B, S, H, Hkv, D, dtype):
    arrays = _inputs(0, B, S, H, Hkv, D)
    got = TO.flash_attention(*_torch(arrays, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    kernel = JO.flash_attention(*_jax(arrays, dtype))
    oracle = attention_reference(*_jax(arrays, "float32"))
    np.testing.assert_allclose(np_of(got), np_of(kernel), **tol(dtype))
    np.testing.assert_allclose(np_of(got), np_of(oracle), **tol(dtype))


@pytest.mark.parametrize("kw", [dict(window=16), dict(window=64),
                                dict(prefix_len=32)],
                         ids=["window16", "window64", "prefix32"])
def test_flash_attention_options_match_jax(kw):
    S = 128 if "prefix_len" in kw else 256
    H = 4
    Hkv = 4 if "prefix_len" in kw else 2
    arrays = _inputs(1, 1, S, H, Hkv, 64)
    got = TO.flash_attention(*_torch(arrays, "float32"), **kw)
    for want in (JO.flash_attention(*_jax(arrays, "float32"), **kw),
                 attention_reference(*_jax(arrays, "float32"), **kw)):
        np.testing.assert_allclose(np_of(got), np_of(want),
                                   **tol("float32"))


@pytest.mark.parametrize("S,kw", [
    (100, dict(causal=False)),           # ragged S, no mask
    (256, dict(prefix_len=200)),         # prefix tiles above the diagonal
    (256, dict(window=16, prefix_len=48)),
])
def test_flash_attention_follows_the_oracle(S, kw):
    """Cases where the JAX kernel's wrapper leaves its oracle: with
    ``causal=False`` it pads S with zero keys that enter the softmax, and
    it skips kv blocks above the diagonal that lie in the prefix.  The
    port follows ``attention_reference``."""
    arrays = _inputs(2, 1, S, 2, 2, 64)
    got = TO.flash_attention(*_torch(arrays, "float32"), **kw)
    want = attention_reference(*_jax(arrays, "float32"), **kw)
    np.testing.assert_allclose(np_of(got), np_of(want), **tol("float32"))


def test_visible_mask_matches_jax_causal_mask():
    from repro.models.common import causal_mask
    pos = jnp.arange(40)
    for kw in (dict(), dict(window=7), dict(prefix_len=9),
               dict(window=5, prefix_len=12)):
        want = np.asarray(causal_mask(pos, pos, **kw))
        np.testing.assert_array_equal(TR.visible(40, **kw).numpy(), want)
    assert TR.visible(5, causal=False).all()


def test_flash_attention_is_forward_only():
    q, k, v = _torch(_inputs(3, 1, 16, 4, 2, 16), "float32")
    q.requires_grad_(True)
    out = TO.flash_attention(q, k, v)
    assert out.requires_grad
    with pytest.raises(TO.NoBackwardError, match="forward-only"):
        out.sum().backward()
    assert q.grad is None
    assert not issubclass(TO.NoBackwardError, RuntimeError)  # not retried


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    arrays = _torch(_inputs(4, 1, 20, 4, 2, 16), "float32")
    n0 = TK.flash_attention_cuda.launches
    got = TO.flash_attention(*arrays)
    assert TK.flash_attention_cuda.launches == n0
    torch.testing.assert_close(got, TR.attention_reference(*arrays),
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="expected a tensor on"):
        TK.flash_attention_cuda(*_torch(_inputs(5, 1, 8, 2, 2, 64),
                                        "float32"))
