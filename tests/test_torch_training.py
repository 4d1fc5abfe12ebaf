"""The port's training substrate against ``repro.training`` on the CPU, at
the reduced SmolLM width in fp32: ``train_loss`` value and gradients
against ``jax.value_and_grad``, AdamW and its schedules, microbatch
equivalence and convergence (as ``tests/test_training.py``), the
synthetic data pipeline, the forward-only flash path, the functional
step under retries, and the trainer CLI with checkpoint resume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import batch_for_step as jbatch_for_step
from repro.data import batch_with_frontend as jbatch_with_frontend
from repro.models import model as JM
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import adamw_update as jadamw_update
from repro.training import init_adamw as jinit_adamw
from repro.training import lr_at as jlr_at
from repro_torch.data import DataConfig, batch_for_step, batch_with_frontend
from repro_torch.data import data_iterator
from repro_torch.distributed import StragglerMonitor, run_with_retries
from repro_torch.kernels.flash_attention import NoBackwardError
from repro_torch.models import model as TM
from repro_torch.training import (AdamWConfig, adamw_update, global_norm,
                                  init_adamw, lr_at, make_loss_fn,
                                  make_train_step, value_and_grad)
from repro_torch.training.optimizer import tree_leaves, tree_map

from _torch_parity import params_pair, reduced_pair

torch.set_num_threads(2)

GRAD_TOL = dict(rtol=5e-4, atol=5e-6)


@pytest.fixture(scope="module")
def smollm():
    jcfg, tcfg = reduced_pair("smollm-360m")
    jp, tp = params_pair(jcfg)
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=8)
    return jcfg, tcfg, jp, tp, dc


def _batch(dc, step=0):
    return {k: torch.from_numpy(v).long()
            for k, v in batch_for_step(dc, step).items()}


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _assert_tree_equal(a, b):
    for (na, x), (nb, y) in zip(_named(a), _named(b)):
        assert na == nb and torch.equal(x, y), na


# --------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------- #

def test_train_loss_value_and_grads_match_jax(smollm):
    jcfg, tcfg, jp, tp, dc = smollm
    batch = batch_for_step(dc, 0)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(jcfg, p, {k: jnp.asarray(v)
                                          for k, v in batch.items()}))(jp)
    loss, grads = value_and_grad(make_loss_fn(tcfg))(tp, _batch(dc, 0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = dict(_named(jax.tree.map(np.asarray, jgrads)))
    tg = dict(_named(grads))
    assert set(tg) == set(jg) and len(tg) == 11   # tied embeddings
    for name, g in tg.items():
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), jg[name], **GRAD_TOL,
                                   err_msg=name)


def test_remat_does_not_change_grads(smollm):
    _, tcfg, _, tp, dc = smollm
    batch = _batch(dc, 1)
    l1, g1 = value_and_grad(make_loss_fn(tcfg, remat=True))(tp, batch)
    l2, g2 = value_and_grad(make_loss_fn(tcfg, remat=False))(tp, batch)
    assert float(l1) == float(l2)
    for (n, a), (_, b) in zip(_named(g1), _named(g2)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("remat", [True, False])
def test_backward_through_flash_raises(smollm, remat):
    _, tcfg, _, tp, dc = smollm
    step = make_train_step(tcfg, AdamWConfig(), impl="flash", remat=remat)
    state = init_adamw(tp)
    calls = []

    def counted(*a):
        calls.append(1)
        return step(*a)

    with pytest.raises(NoBackwardError, match="no backward"):
        run_with_retries(counted, tp, state, _batch(dc), sleep=lambda s: None)
    assert len(calls) == 1                      # not retried
    with torch.no_grad():                       # the forward runs
        fl = TM.train_loss(tcfg, tp, _batch(dc), impl="flash", remat=remat)
        ref = TM.train_loss(tcfg, tp, _batch(dc), remat=remat)
    torch.testing.assert_close(fl, ref, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=60, schedule=schedule,
              min_lr_ratio=0.1)
    for s in (0, 1, 3, 7, 8, 30, 59, 60, 80):
        want = float(jlr_at(JAdamWConfig(**kw), jnp.asarray(s, jnp.int32)))
        got = lr_at(AdamWConfig(**kw), torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def test_lr_schedule_shapes():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      schedule="cosine", min_lr_ratio=0.1)
    assert float(lr_at(cfg, torch.tensor(0))) == 0.0
    assert float(lr_at(cfg, torch.tensor(10))) == 1.0
    assert abs(float(lr_at(cfg, torch.tensor(110))) - 0.1) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    jcfg, _ = reduced_pair("smollm-360m", dtype=dtype)
    jp, tp = params_pair(jcfg, seed=1)
    rs = np.random.RandomState(0)
    gnp = tree_map(lambda p: (rs.randn(*p.shape) * 0.05).astype(np.float32),
                   tp)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=0.5)
    js, ts = jinit_adamw(jp), init_adamw(tp)
    jparams, tparams = jp, tp
    for _ in range(3):
        jparams, js, jm = jadamw_update(
            JAdamWConfig(**kw), jax.tree.map(jnp.asarray, gnp), js, jparams)
        tparams, ts, tm = adamw_update(
            AdamWConfig(**kw), tree_map(torch.from_numpy, gnp), ts, tparams)
    assert int(ts.step) == int(js.step) == 3
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-6)
    for jt, tt in ((js.master, ts.master), (js.mu, ts.mu), (js.nu, ts.nu),
                   (jparams, tparams)):
        jn = dict(_named(jax.tree.map(
            lambda a: np.asarray(a).astype(np.float32), jt)))
        for name, t in _named(tt):
            np.testing.assert_allclose(t.float().numpy(), jn[name],
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    for name, t in _named(tparams):
        assert t.dtype == getattr(torch, dtype), name


def test_init_adamw_leaves_are_distinct_fp32_buffers(smollm):
    _, _, _, tp, _ = smollm
    st = init_adamw(tp)
    ptrs = [t.data_ptr() for t in tree_leaves(tp)]
    for tree in (st.master, st.mu, st.nu):
        for t in tree_leaves(tree):
            assert t.dtype == torch.float32 and t.data_ptr() not in ptrs
            ptrs.append(t.data_ptr())
    assert st.step.dtype == torch.int32 and int(st.step) == 0


def test_grad_clip_bounds_update(smollm):
    _, _, _, tp, _ = smollm
    opt = AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0,
                      total_steps=10, warmup_steps=0, schedule="constant")
    big = tree_map(lambda p: torch.full(p.shape, 1e6), tp)
    p2, _, m = adamw_update(opt, big, init_adamw(tp), tp)
    assert float(m["grad_norm"]) > 1e6
    assert float(global_norm(big)) == float(m["grad_norm"])
    delta = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(p2), tree_leaves(tp)))
    assert delta < 1.1


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #

def test_loss_decreases(smollm):
    _, tcfg, _, tp, _ = smollm
    opt = AdamWConfig(lr=1e-3, total_steps=30, warmup_steps=2)
    state = init_adamw(tp)
    step = make_train_step(tcfg, opt)
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=8)
    batch = _batch(dc, 0)                      # overfit one batch
    params, losses = tp, []
    for _ in range(25):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_microbatch_equivalence(smollm):
    """mb-accumulated gradients == full-batch gradients (fp32)."""
    _, tcfg, _, tp, dc = smollm
    batch = _batch(dc, 0)
    vg = value_and_grad(make_loss_fn(tcfg))
    full_loss, full_grads = vg(tp, batch)
    for mb in (2, 4):
        n = 8 // mb
        parts = [vg(tp, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                 for i in range(mb)]
        np.testing.assert_allclose(np.mean([float(l) for l, _ in parts]),
                                   float(full_loss), rtol=1e-5)
        acc = tree_map(lambda *g: sum(g) / mb, *(g for _, g in parts))
        for (name, a), (_, b) in zip(_named(acc), _named(full_grads)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL,
                                       err_msg=name)
    opt = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    for mb in (1, 2):
        step = make_train_step(tcfg, opt, microbatches=mb)
        _, _, m = step(tp, init_adamw(tp), batch)
        np.testing.assert_allclose(float(m["loss"]), float(full_loss),
                                   rtol=1e-4)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tcfg, opt, microbatches=3)(tp, init_adamw(tp), batch)


def test_train_step_leaves_its_inputs_unmodified(smollm):
    _, tcfg, _, tp, dc = smollm
    step = make_train_step(tcfg, AdamWConfig(lr=1e-2, warmup_steps=1),
                           microbatches=2)
    state = init_adamw(tp)
    p0, s0 = _clone(tp), state._replace(
        master=_clone(state.master), mu=_clone(state.mu),
        nu=_clone(state.nu), step=state.step.clone())
    batch = _batch(dc, 0)
    params, new_state, _ = step(tp, state, batch)
    _assert_tree_equal(tp, p0)
    for a, b in ((state.master, s0.master), (state.mu, s0.mu),
                 (state.nu, s0.nu)):
        _assert_tree_equal(a, b)
    assert int(state.step) == 0 and int(new_state.step) == 1
    assert not torch.equal(params["embed"], tp["embed"])
    assert all(t.grad is None for t in tree_leaves(tp))


def test_retried_step_equals_a_clean_step(smollm):
    """``run_with_retries`` re-runs a step that failed after it had done
    its work: the functional step gives what one clean call gives."""
    _, tcfg, _, tp, dc = smollm
    step = make_train_step(tcfg, AdamWConfig(lr=1e-2, warmup_steps=1))
    batch = _batch(dc, 2)
    clean = step(tp, init_adamw(tp), batch)
    fails = [1]

    def flaky(*a):
        out = step(*a)
        if fails:
            fails.pop()
            raise RuntimeError("transient device fault")
        return out

    waits = []
    state = init_adamw(tp)
    got = run_with_retries(flaky, tp, state, batch, sleep=waits.append)
    assert waits == [0.1]
    _assert_tree_equal(got[0], clean[0])
    _assert_tree_equal(got[1].master, clean[1].master)
    assert float(got[2]["loss"]) == float(clean[2]["loss"])


def test_straggler_monitor():
    mon = StragglerMonitor(deadline_factor=2.0, min_floor_s=0.5)
    assert not mon.observe(1.0, 1.5)
    assert mon.observe(1.0, 2.5)
    assert not mon.observe(0.01, 0.4)          # under the floor
    assert [(e.batch_index, e.actual_s) for e in mon.events] == [(2, 2.5)]


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("shard,num_shards", [(0, 1), (0, 2), (1, 2)])
def test_batch_for_step_identical_to_jax(shard, num_shards):
    kw = dict(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    for step in (0, 5, 17):
        want = jbatch_for_step(JDataConfig(**kw), step, shard=shard,
                               num_shards=num_shards)
        got = batch_for_step(DataConfig(**kw), step, shard=shard,
                             num_shards=num_shards)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_data_iterator_and_frontend_batches_identical_to_jax():
    jcfg = jax_get_config("smollm-360m")
    _, tcfg = reduced_pair("smollm-360m")
    kw = dict(vocab_size=500, seq_len=8, global_batch=4)
    it = data_iterator(DataConfig(**kw), start_step=3)
    for step in (3, 4, 5):
        want = jbatch_with_frontend(jcfg, JDataConfig(**kw), step)
        got = batch_with_frontend(tcfg, DataConfig(**kw), step)
        nxt = next(it)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(nxt[k], want[k])


# --------------------------------------------------------------------- #
# the trainer CLI
# --------------------------------------------------------------------- #

def test_trainer_runs_checkpoints_and_resumes(tmp_path):
    from repro_torch.launch import train as T
    argv = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
            "--lr", "1e-3", "--ckpt-dir", str(tmp_path), "--ckpt-interval",
            "2", "--microbatches", "2"]
    hist = T.train(T.parse_args(argv))
    assert len(hist) == 4
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    from repro_torch.checkpoint import list_steps
    assert list_steps(str(tmp_path))[-1] == 4
    more = T.train(T.parse_args(argv[:3] + ["6"] + argv[4:] + ["--resume"]))
    assert len(more) == 2                         # steps 4 and 5
    assert T.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                   "--seq", "8"]) == 0
