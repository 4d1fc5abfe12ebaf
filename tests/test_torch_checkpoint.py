"""The port's checkpoint store and manager (the cases of
``tests/test_checkpoint.py``, on trees of torch tensors) and its
compatibility with the JAX store: leaf names, the on-disk layout, and
bf16 leaves written by one package and read by the other, without
``ml_dtypes`` on the port's side."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.store as jstore
import repro_torch.checkpoint.store as store
from repro.training import init_adamw as jinit_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.training import init_adamw

from _torch_parity import params_pair, reduced_pair


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 16), generator=g),
        "b": torch.randn((16,), generator=g).to(torch.bfloat16),
        "nested": {"s": torch.tensor(3, dtype=torch.int32)},
    }


def _leaves(t):
    return [leaf for _, leaf in store.flatten_with_names(t)]


def assert_tree_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_roundtrip_bf16(tmp_path):
    t = tree()
    store.save(t, str(tmp_path), 7)
    restored, step = store.restore(t, str(tmp_path))
    assert step == 7
    assert_tree_equal(t, restored)


def test_latest_and_retention(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4):
        store.save(t, str(tmp_path), s)
    assert store.list_steps(str(tmp_path)) == [1, 2, 3, 4]
    store.retain(str(tmp_path), keep=2)
    assert store.list_steps(str(tmp_path)) == [3, 4]
    _, step = store.restore(t, str(tmp_path))
    assert step == 4


def test_corruption_detected_and_skipped(tmp_path):
    t = tree()
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=5,
                            async_write=False)
    mgr.save(t, 1, block=True)
    mgr.save(tree(seed=1), 2, block=True)
    path = sorted(glob.glob(str(tmp_path) + "/step_*"))[-1]
    f = os.path.join(path, "leaves.npz")
    size = os.path.getsize(f)
    with open(f, "r+b") as fh:
        fh.seek(size // 2)
        fh.write(os.urandom(64))
    assert not store.verify(path)
    restored, step = mgr.restore_latest(t)
    assert step == 1                          # fell back to the valid one
    assert_tree_equal(t, restored)


def test_async_save_then_restore(tmp_path):
    t = tree()
    saved = tree()
    mgr = CheckpointManager(str(tmp_path), interval=2, keep=3)
    assert mgr.maybe_save(t, 2)
    assert not mgr.maybe_save(t, 3)
    t["w"].add_(1.0)              # the snapshot was taken at save time
    mgr.wait()
    restored, step = mgr.restore_latest(t)
    assert step == 2
    assert_tree_equal(saved, restored)


def test_failure_injection_keeps_previous(tmp_path):
    t = tree()
    mgr = CheckpointManager(str(tmp_path), interval=1, async_write=False)
    mgr.save(t, 1, block=True)

    def boom(step):
        raise RuntimeError("disk died")

    mgr.failure_injection = boom
    with pytest.raises(RuntimeError):
        mgr.save(tree(seed=2), 2, block=True)
    _, step = mgr.restore_latest(t)
    assert step == 1


def test_uncommitted_tmp_ignored(tmp_path):
    t = tree()
    store.save(t, str(tmp_path), 1)
    os.makedirs(str(tmp_path) + "/step_000000002")   # no COMMITTED marker
    assert store.list_steps(str(tmp_path)) == [1]


# --------------------------------------------------------------------- #
# compatibility with the JAX store
# --------------------------------------------------------------------- #

def _train_state(dtype):
    jcfg, _ = reduced_pair("smollm-360m", dtype=dtype)
    jp, tp = params_pair(jcfg, seed=3)
    return ({"params": jp, "opt": jinit_adamw(jp)},
            {"params": tp, "opt": init_adamw(tp)})


def test_leaf_names_are_the_jax_stores():
    jtree, ttree = _train_state("bfloat16")
    jnames = [n for n, _ in jstore._flatten_with_names(jtree)[0]]
    tnames = [n for n, _ in store.flatten_with_names(ttree)]
    assert tnames == jnames
    assert "opt/.master/layers/attn/wq" in tnames


def test_restores_bf16_params_the_jax_store_wrote(tmp_path):
    jtree, ttree = _train_state("bfloat16")
    jstore.save(jtree, str(tmp_path), 5)
    template = store.unflatten_like(ttree, {
        n: torch.zeros_like(t) for n, t in store.flatten_with_names(ttree)})
    restored, step = store.restore(template, str(tmp_path))
    assert step == 5
    jn = dict(jstore._flatten_with_names(jtree)[0])
    for name, t in store.flatten_with_names(restored):
        want = np.asarray(jn[name])
        assert str(t.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      want.astype(np.float32), err_msg=name)
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert type(restored["opt"]) is type(ttree["opt"])


def test_jax_store_restores_what_the_port_wrote(tmp_path):
    jtree, ttree = _train_state("bfloat16")
    path = store.save(ttree, str(tmp_path), 9)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"
    zeros = jax.tree.map(jnp.zeros_like, jtree)
    restored, step = jstore.restore(zeros, str(tmp_path))
    assert step == 9
    for (name, a), (_, b) in zip(jstore._flatten_with_names(restored)[0],
                                 jstore._flatten_with_names(jtree)[0]):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
