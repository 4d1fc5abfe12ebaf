"""The port's distributed layer (``repro_torch.distributed``,
``launch.mesh``) against the JAX package on the CPU.

* Sharding rules: the port's ``param_pspecs`` / ``batch_pspecs`` /
  ``out_pspecs_decode`` are JAX's specs, entry for entry, for every
  assigned arch (shape-only trees on both sides, production meshes
  described by their axes), and JAX's "divides 16" and vocab-padding
  checks hold on the port's specs.
* Compression: the error-feedback invariant, the long-run bias, the
  quantizer's bits against JAX's, and ``compressed_psum`` on 2 ``gloo``
  ranks against JAX's own function run on one device under ``vmap``.
* Multi-rank paths on ``gloo`` CPU ranks (``launch.mesh.run_ranks``,
  each spawn with its own timeout, process groups from a ``FileStore``
  in a temporary directory, so no port is fixed): the sequence-sharded
  decode and its partials merge on (2, 4), ``elastic_remesh`` 8 -> 5
  ranks with ``reshard`` and a forward, seqsharded ``decode_step`` /
  ``decode_step_deferred`` on reduced TinyLlama, ``apply_moe_ep`` for
  both MoE archs and the sharded train step on reduced SmolLM-360M, each
  against the JAX package's single-device function.  The ranks import
  the port only (``tests/_torch_dist_workers.py``); inputs and results
  cross as numpy arrays.

The microbatched train step is compared at AdamW eps 1e-6, JAX's test's
step at the default 1e-8.  At 1e-8 an element whose gradient is itself
~1e-8 (numerically zero) has an update ``lr * g / (|g| + eps)`` that a
1e-9 change of ``g`` moves by ~3% of ``lr``.  The change is fp32
rounding between torch and XLA, not the mesh: the port's one-rank,
unsharded ``microbatches=2`` step already moves one element of 90,432
past ``rtol=1e-4`` / ``atol=1e-5`` at eps 1e-8 (reduced SmolLM-360M,
fp32, seed 0, 16 tokens x 4 rows, against JAX's one-device step; so
does the (2, 1) mesh, by the same element), while JAX's own (2, 1) step
is bit-equal to its one-device step.  At 1e-6 the update is Lipschitz
in ``g`` with constant ``lr / eps``, and all of these are within the
bound, so the tolerance tests the sharding, not fp32's last bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.configs import ASSIGNED_ARCHS, SHAPES
from repro.configs import get_config as jax_get_config
from repro.data import DataConfig, batch_for_step
from repro.distributed import collectives as jcoll
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jshard
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.serving import serve_step as jserve
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import init_adamw as j_init_adamw
from repro.training import make_loss_fn as j_make_loss_fn
from repro.training import make_train_step as j_make_train_step
from repro_torch.configs import get_config as torch_get_config
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tshard
from repro_torch.distributed.context import P, placements
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import attention as tattn
from repro_torch.serving import serve_step as tserve

from _torch_parity import reduced_pair

MODEL_PAR = 16
#: every spawn's own limit: a hung rank fails its test, not the suite.
#: A spawn takes 10-60 s alone here (8 ranks the longest; DTensor's first
#: step on a 2-D mesh ~20 s a rank); 240 s leaves room for a loaded host
SPAWN_TIMEOUT_S = 240.0
#: tests/test_distributed.py's tolerances
DECODE_TOL = dict(rtol=2e-5, atol=2e-5)
MOE_TOL = dict(rtol=2e-4, atol=2e-4)
#: tests/test_torch_train_families.py's gradient tolerance
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)
#: tests/test_torch_models.py's tolerance for logits
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
#: AdamW's eps for the microbatched step's comparison (module docstring)
EPS_MICROBATCHED = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------- #
# sharding rules: spec arithmetic on shape-only trees
# --------------------------------------------------------------------- #


class _JaxMesh:
    """What JAX's rules read of a mesh: its axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names, self.shape = axes, dict(zip(axes, shape))


class _TorchMesh:
    """What the port's rules read of a ``DeviceMesh``."""

    def __init__(self, shape, axes):
        self.mesh_dim_names, self._shape = axes, shape

    def size(self, i):
        return self._shape[i]


#: the production meshes (``launch.mesh.make_production_mesh``)
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jshard._path_names(p): tuple(s) for p, s in flat}


def _torch_specs(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_torch_specs(v, path + (k,)))
        else:
            assert isinstance(v, P), (path, k, v)
            out[path + (k,)] = tuple(v)
    return out


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_pspecs_match_jax(arch, fsdp):
    want = jshard.param_pspecs(jax_get_config(arch),
                               jserve.param_specs(jax_get_config(arch)),
                               fsdp=fsdp)
    tcfg = torch_get_config(arch)
    got = tshard.param_pspecs(tcfg, tserve.param_specs(tcfg), fsdp=fsdp)
    assert _torch_specs(got) == _jax_specs(want)


@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_and_decode_out_pspecs_match_jax(arch, seq_shard):
    jcfg, tcfg = jax_get_config(arch), torch_get_config(arch)
    for shape, axes in MESHES.values():
        jm, tm = _JaxMesh(shape, axes), _TorchMesh(shape, axes)
        for cell in ("train_4k", "prefill_32k", "decode_32k"):
            sc = SHAPES[cell]
            want = jshard.batch_pspecs(jcfg, sc, jm, seq_shard=seq_shard)
            got = tshard.batch_pspecs(tcfg, sc, tm, seq_shard=seq_shard)
            assert _torch_specs(got) == _jax_specs(want), (axes, cell)
        sc = SHAPES["decode_32k"]
        jl, jc = jshard.out_pspecs_decode(jcfg, sc, jm, seq_shard=seq_shard)
        tl, tc = tshard.out_pspecs_decode(tcfg, sc, tm, seq_shard=seq_shard)
        assert tuple(tl) == tuple(jl)
        assert _torch_specs(tc) == _jax_specs(jc)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_sharded_dims_divide_16(arch):
    """JAX's check on the port's specs: every dim a spec puts on the
    'model' (or 'data') axis divides 16."""
    cfg = torch_get_config(arch)
    shapes = tserve.param_specs(cfg)
    specs = tshard.param_pspecs(cfg, shapes, fsdp=True)

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v
    flat = dict(leaves(shapes))
    spec = _torch_specs(specs)
    assert spec.keys() == flat.keys()
    for path, s in spec.items():
        for dim, axis in enumerate(s):
            axes = axis if isinstance(axis, tuple) else (axis,)
            if "model" in axes or "data" in axes:
                assert flat[path].shape[dim] % MODEL_PAR == 0, (path, s)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_vocab_padding_multiple(arch):
    cfg = torch_get_config(arch)
    assert cfg.padded_vocab % 256 == 0
    assert cfg.padded_vocab % MODEL_PAR == 0
    if cfg.num_experts:
        assert cfg.padded_experts % MODEL_PAR == 0


def test_partition_spec_normalizes_and_places_like_jax():
    from torch.distributed.tensor import Replicate, Shard
    for dims in [((),), (("data",), None), (("pod", "data"), "model"),
                 (None, "model", None), ()]:
        assert tuple(P(*dims)) == tuple(jax.sharding.PartitionSpec(*dims))
    mesh = _TorchMesh((2, 2, 4), ("pod", "data", "model"))
    assert placements(mesh, P(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(mesh, P(None, "data")) == [Replicate(), Shard(1),
                                                 Replicate()]


# --------------------------------------------------------------------- #
# compression
# --------------------------------------------------------------------- #


def test_error_feedback_invariant():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal(256).astype(np.float32),
         "b": rng.standard_normal((4, 8)).astype(np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    err = tcomp.init_error_state(tg)
    (q, err2, deq) = tcomp.compress_with_feedback(tg, err)
    jq, jerr2, jdeq = jcomp.compress_with_feedback(
        {k: jnp.asarray(v) for k, v in g.items()},
        jcomp.init_error_state({k: jnp.asarray(v) for k, v in g.items()}))
    for k in g:
        lhs = g[k] + err[k].numpy()
        rhs = deq[k].numpy() + err2[k].numpy()
        np.testing.assert_allclose(lhs, rhs, atol=1e-6)
        # the quantizer's bits are JAX's (round half to even)
        np.testing.assert_array_equal(q[k][0].numpy(), np.asarray(jq[k][0]))
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))


def test_error_feedback_long_run_unbiased():
    """Sum of compressed grads tracks the true sum within one step's
    quantization error."""
    rng = np.random.default_rng(1)
    err = tcomp.init_error_state({"w": torch.zeros(64)})
    true_sum = np.zeros(64)
    deq_sum = np.zeros(64)
    for t in range(50):
        g = {"w": torch.from_numpy(
            (rng.standard_normal(64) * (1 + t % 5)).astype(np.float32))}
        _, err, deq = tcomp.compress_with_feedback(g, err)
        true_sum += g["w"].numpy()
        deq_sum += deq["w"].numpy()
    assert np.abs(true_sum - deq_sum).max() < 0.2


# --------------------------------------------------------------------- #
# 8 ranks: sequence-sharded decode on (2, 4), then elastic remesh
# --------------------------------------------------------------------- #

B, S, H, HKV, D = 4, 64, 8, 2, 32
LENS = np.array([3, 17, 40, 64], np.int32)
LENS_PARTIALS = np.array([3, 17, 40, 63], np.int32)


@pytest.fixture(scope="module")
def eight_ranks():
    k0 = jax.random.PRNGKey(0)
    q = jax.random.normal(k0, (B, H, D))
    k = jax.random.normal(jax.random.fold_in(k0, 1), (B, S, HKV, D))
    v = jax.random.normal(jax.random.fold_in(k0, 2), (B, S, HKV, D))
    jcfg, _ = reduced_pair("smollm-360m")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                         jcfg.vocab_size))
    ranks = run_ranks(W.seqsharded, 8, *(np.asarray(a) for a in (q, k, v)),
                      LENS, LENS_PARTIALS, 5, _np_tree(jp), toks,
                      device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return dict(q=q, k=k, v=v, jcfg=jcfg, jp=jp, toks=toks, ranks=ranks)


def test_seqsharded_flash_decode_matches_reference(eight_ranks):
    e = eight_ranks
    ref = jcoll.decode_attn_reference(e["q"], e["k"], e["v"],
                                      jnp.asarray(LENS))
    for r in e["ranks"]:
        np.testing.assert_allclose(r["decode"], np.asarray(ref),
                                   **DECODE_TOL)


def test_seqsharded_decode_partials_merge(eight_ranks):
    """Partials + the two-group merge (the port's) == JAX's reference
    with the new token appended at each row's length."""
    e = eight_ranks
    k0 = jax.random.PRNGKey(0)
    k_new = jax.random.normal(jax.random.fold_in(k0, 3), (B, HKV, D))
    v_new = jax.random.normal(jax.random.fold_in(k0, 4), (B, HKV, D))
    G = H // HKV
    qg = np.asarray(e["q"]).reshape(B, HKV, G, D)
    s2 = np.einsum("bhgd,bhd->bhg", qg, np.asarray(k_new)) / np.sqrt(D)
    v2 = np.broadcast_to(np.asarray(v_new)[:, :, None, :], (B, HKV, G, D))
    rows = jnp.arange(B)
    lens = jnp.asarray(LENS_PARTIALS)
    ref = jcoll.decode_attn_reference(
        e["q"], e["k"].at[rows, lens].set(k_new),
        e["v"].at[rows, lens].set(v_new), lens + 1)
    for r in e["ranks"]:
        out1, m1, l1 = (torch.from_numpy(a) for a in r["partials"])
        merged = tattn.merge_softmax_groups(
            out1.reshape(B, HKV, G, D), m1.reshape(B, HKV, G),
            l1.reshape(B, HKV, G), torch.from_numpy(s2.astype(np.float32)),
            torch.from_numpy(np.ascontiguousarray(v2, np.float32)))
        np.testing.assert_allclose(merged.reshape(B, H, D).numpy(),
                                   np.asarray(ref), **DECODE_TOL)


def test_elastic_remesh_shrink_and_reshard(eight_ranks):
    """8 ranks -> (4, 2); 5 survivors -> (2, 2) on ranks 0-3 (rank 4 and
    the lost ranks wait at the barrier); the resharded forward's loss is
    finite and JAX's."""
    e = eight_ranks
    want = float(JM.train_loss(e["jcfg"], e["jp"],
                               {"tokens": jnp.asarray(e["toks"]),
                                "labels": jnp.asarray(e["toks"])}))
    for rank, r in enumerate(e["ranks"]):
        assert r["mesh_all"] == {"data": 4, "model": 2}
        if rank >= 4:
            assert "mesh_survivors" not in r
            continue
        assert r["mesh_survivors"] == {"data": 2, "model": 2}
        assert np.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], want, rtol=1e-5)


# --------------------------------------------------------------------- #
# 4 ranks: the model functions under a (2, 2) mesh
# --------------------------------------------------------------------- #

STEPS, PROMPT, CACHE_LEN = 4, 5, 16


@pytest.fixture(scope="module")
def model_paths():
    """Two (2, 2) spawns: ``compressed_psum``, ``axis_index`` and the
    seqsharded decode steps; ``apply_moe_ep`` and the EP train step.
    JAX's side here."""
    rng = np.random.default_rng(2)
    grads = [{"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": (rng.standard_normal(8) * 1e-3).astype(np.float32)}
             for _ in range(2)]
    jcfg, _ = reduced_pair("tinyllama-1.1b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    greedy = {}
    for name in ("decode_step", "decode_step_deferred"):
        fn = getattr(JM, name)
        lg, cache = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)},
                               cache_len=CACHE_LEN)
        toks, logits = [], []
        for _ in range(STEPS):
            nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(nxt))
            lg, cache = fn(jcfg, jp, nxt, cache, impl="reference")
            logits.append(np.asarray(lg))
        greedy[name] = (np.stack(toks, 1), np.stack(logits))
    # the port is fed JAX's greedy tokens (its argmax is checked)
    forced = greedy["decode_step"][0]
    assert np.array_equal(forced, greedy["decode_step_deferred"][0])
    moe_in, moe_want = {}, {}
    for arch in MOE_ARCHS:
        mcfg, _ = reduced_pair(arch)
        mp = JM.init_params(mcfg, jax.random.PRNGKey(0))
        layer = jax.tree.map(lambda a: np.asarray(a[0]),
                             mp["layers"]["moe"])
        x = (np.random.default_rng(4).standard_normal(
            (2, 16, mcfg.d_model)) * 0.5).astype(np.float32)
        moe_in[arch] = (layer, x)
        jl, jx = jax.tree.map(jnp.asarray, layer), jnp.asarray(x)
        y, vjp = jax.vjp(lambda p: jmoe.apply_moe(p, mcfg, jx), jl)
        moe_want[arch] = (np.asarray(y), _np_tree(vjp(2 * y)[0]))
    tcfg, _ = reduced_pair("qwen2-moe-a2.7b")
    tp = JM.init_params(tcfg, jax.random.PRNGKey(0))
    batch = batch_for_step(DataConfig(vocab_size=tcfg.vocab_size,
                                      seq_len=16, global_batch=4), 0)
    ranks = run_ranks(W.decode_paths, 4, grads,
                      ("tinyllama-1.1b", _np_tree(jp), prompt, forced,
                       CACHE_LEN), device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    moe_ranks = run_ranks(W.moe_paths, 4, moe_in,
                          ("qwen2-moe-a2.7b", _np_tree(tp), _np_tree(batch)),
                          device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    ranks = [{**r, **m} for r, m in zip(ranks, moe_ranks)]
    return dict(grads=grads, greedy=greedy, moe=moe_want, ranks=ranks)


def test_compressed_psum_matches_jax(model_paths):
    """Over the 2 ``data`` ranks of (2, 2), against JAX's own function
    on one device under ``vmap``."""
    grads = model_paths["grads"]
    stacked = {k: jnp.stack([jnp.asarray(g[k]) for g in grads])
               for k in grads[0]}
    want, want_err = jax.vmap(
        lambda g, e: jcomp.compressed_psum(g, e, "data"), axis_name="data")(
        stacked, jax.tree.map(jnp.zeros_like, stacked))
    for rank, r in enumerate(model_paths["ranks"]):
        red, err = r["psum"]
        d = rank // 2                        # the rank's data index
        for k in grads[0]:
            np.testing.assert_allclose(red[k], np.asarray(want[k][d]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(err[k], np.asarray(want_err[k][d]),
                                       rtol=1e-6, atol=1e-7)


def test_axis_index_is_the_all_to_all_order(model_paths):
    for r in model_paths["ranks"]:
        me, coord, got = r["axis_order"]
        assert me == coord
        # block i of every rank came to rank i: rank me holds 100 j + me
        assert got == [100 * j + me for j in range(2)]


@pytest.mark.parametrize("fn", ["decode_step", "decode_step_deferred"])
def test_seqsharded_decode_step_matches_jax_reference(model_paths, fn):
    toks, logits = model_paths["greedy"][fn]
    for r in model_paths["ranks"]:
        got, cache_type = r[fn]
        assert cache_type == "DTensor"          # the cache stays sharded
        np.testing.assert_allclose(got, logits, **LOGIT_TOL)
        # greedy tokens equal: each step's argmax is JAX's next token
        assert np.array_equal(got[:-1].argmax(-1).T, toks[:, 1:])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_moe_matches_dense_dispatch(model_paths, arch):
    """apply_moe_ep (all-to-all over 'model') == JAX's dense dispatch,
    padded experts and the shared expert included (nothing overflows at
    capacity 8.0), and so do the gradients of ``sum(y ** 2)`` with
    respect to the router and the experts."""
    want_y, want_g = model_paths["moe"][arch]
    for r in model_paths["ranks"]:
        y, grads = r[arch]
        np.testing.assert_allclose(y, want_y, **MOE_TOL)
        assert grads.keys() >= {"router", "wi_gate", "wi_up", "wo"}
        for k, g in grads.items():
            assert np.isfinite(g).all(), k
            np.testing.assert_allclose(g, want_g[k], err_msg=k, **MOE_TOL)


def test_ep_train_step_runs_on_dtensor_params(model_paths):
    """``make_train_step(moe_impl="ep")`` on reduced qwen2-moe's DTensor
    params on (2, 2): a finite loss and gradient norm, the params still
    DTensors.  (Its capacity, 1.25 as in JAX, may drop tokens, so it has
    no single-device equal; the layer is held above at capacity 8.)"""
    for r in model_paths["ranks"]:
        loss, gnorm, placed = r["ep_train"]
        assert np.isfinite(loss) and np.isfinite(gnorm)
        assert placed["layers"]["moe"]["wi_gate"] == "DTensor"
        assert placed["embed"] == "DTensor"


#: (microbatches, AdamW eps, mesh): JAX's test's step on (2, 2), then
#: the microbatched one (``examples/train_multipod.py``) at an eps that
#: keeps AdamW's update well conditioned (module docstring), on (2, 1):
#: microbatches slice the data-sharded batch, and a 1-D mesh spares
#: DTensor's ~20 s a rank of first-step sharding choices on 2-D meshes
TRAIN_CONFIGS = [(1, 1e-8, (2, 2)), (2, EPS_MICROBATCHED, (2, 1))]


@pytest.fixture(scope="module")
def sharded_steps():
    jcfg, _ = reduced_pair("smollm-360m")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    dc = DataConfig(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4)
    batch = batch_for_step(dc, 0)
    grads = _np_tree(jax.grad(j_make_loss_fn(jcfg))(jp, batch))
    want, got = [], []
    for mb, eps, shape in TRAIN_CONFIGS:
        opt = JAdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1, eps=eps)
        p1, _, m1 = jax.jit(j_make_train_step(jcfg, opt, microbatches=mb))(
            jp, j_init_adamw(jp), batch)
        want.append((float(m1["loss"]), float(m1["grad_norm"]),
                     _np_tree(p1), grads))
        got.append(run_ranks(W.train_steps, shape[0] * shape[1],
                             _np_tree(jp), _np_tree(batch), mb, eps, shape,
                             device="cpu", timeout_s=SPAWN_TIMEOUT_S)[0])
    return want, got


@pytest.mark.parametrize("case", range(len(TRAIN_CONFIGS)),
                         ids=[f"microbatches{c[0]}" for c in TRAIN_CONFIGS])
def test_sharded_train_step_matches_single_device(sharded_steps, case):
    """make_train_step on DTensor params == JAX's one-device step (fp32),
    at JAX's tolerances: the loss, and every leaf.  The gradients of the
    whole batch leaf by leaf (``GRAD_TOL``) and the step's grad norm are
    held too: AdamW's update barely moves when a leaf's whole gradient
    is scaled, so the params alone would not show a gradient summed the
    wrong number of times."""
    (want_loss, want_norm, want, want_grads), \
        (loss, norm, got, placed, grads) = (sharded_steps[0][case],
                                            sharded_steps[1][case])
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(norm, want_norm, rtol=1e-4)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(want_grads)[0])
    for path, w in flat_w.items():
        names = jshard._path_names(path)
        g, kind, gr = got, placed, grads
        for n in names:
            g, kind, gr = g[n], kind[n], gr[n]
        assert kind == "DTensor", names          # never cast back
        np.testing.assert_allclose(gr, flat_g[path], **GRAD_TOL,
                                   err_msg=f"grad {names}")
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                   err_msg=str(names))
