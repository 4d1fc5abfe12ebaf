"""Rank functions of ``tests/test_torch_distributed.py``.  Each runs in a
spawned process, one rank of a ``gloo`` group on the CPU
(``repro_torch.launch.mesh.run_ranks``), and imports the port only: no
JAX in the ranks.  Inputs and results cross as numpy arrays; the tests
hold the results against the JAX package's single-device functions."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed import compression as comp
from repro_torch.distributed.context import (P, all_to_all, axis_index,
                                             set_mesh, spmd_scope, to_dtensor)
from repro_torch.distributed.fault_tolerance import elastic_remesh, reshard
from repro_torch.distributed.sharding import fit_specs, param_pspecs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.training import (AdamWConfig, init_adamw, make_loss_fn,
                                  make_train_step, value_and_grad)
from repro_torch.training.optimizer import tree_map


def _np(x) -> np.ndarray:
    """A DTensor's global value, or a tensor, as numpy."""
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    return x.detach().numpy()


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def reduced(name: str):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32")


def seqsharded(rank, world, q, k, v, lens, lens_partials, survivors,
               params, toks):
    """(4) and (8) on 8 ranks: the sequence-sharded decode and its
    partials on a (2, 4) mesh; then ``elastic_remesh`` of all ranks and
    of ``survivors``, ``reshard`` and a forward on the shrunk mesh."""
    mesh = make_test_mesh(2, 4, device="cpu")
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    out = {"decode": _np(C.make_seqsharded_decode_attn(mesh)(
        q, k, v, torch.from_numpy(lens)))}
    out["partials"] = [_np(t) for t in
                       C.make_seqsharded_decode_attn_partials(mesh)(
                           q, k, v, torch.from_numpy(lens_partials))]
    cfg = reduced("smollm-360m")
    m1 = elastic_remesh(list(range(world)), model_parallel=2, device="cpu")
    out["mesh_all"] = dict(zip(m1.mesh_dim_names, m1.shape))
    m2 = elastic_remesh(list(range(survivors)), model_parallel=2,
                        device="cpu")
    if m2 is None:
        return out
    out["mesh_survivors"] = dict(zip(m2.mesh_dim_names, m2.shape))
    p = M.params_from_jax(params, device="cpu")
    p = reshard(p, m2, fit_specs(param_pspecs(cfg, p, fsdp=False), p,
                                 m2))
    t = torch.from_numpy(toks)
    with torch.no_grad():
        out["loss"] = float(_np(M.train_loss(cfg, p, {"tokens": t,
                                                      "labels": t})))
    import torch.distributed as dist
    dist.barrier()                     # release the ranks left out
    return out


def decode_paths(rank, world, grads_by_data, decode_args):
    """(3), (5) and ``axis_index``'s order on a (2, 2) mesh:
    ``compressed_psum`` over ``data`` (data rank d reduces
    ``grads_by_data[d]``, zero error state); prefill, then
    ``decode_step`` and ``decode_step_deferred`` with
    ``impl="seqsharded"``, fed the tokens ``forced`` (B, steps), every
    step's logits."""
    mesh = make_test_mesh(2, 2, device="cpu")
    set_mesh(mesh)
    out = {}
    me = axis_index("model")
    x = torch.arange(2, dtype=torch.float32) + 100 * me
    out["axis_order"] = (me, mesh.get_local_rank("model"),
                         all_to_all(x, "model").tolist())
    g = _tensors(grads_by_data[axis_index("data")])
    red, err = comp.compressed_psum(g, comp.init_error_state(g), "data")
    out["psum"] = (tree_map(_np, red), tree_map(_np, err))

    arch, params, prompt, forced, cache_len = decode_args
    cfg = reduced(arch)
    p = M.params_from_jax(params, device="cpu")
    with torch.no_grad():
        _, cache0 = M.prefill(cfg, p, {"tokens": torch.from_numpy(prompt)},
                              cache_len=cache_len)
        for fn in (M.decode_step, M.decode_step_deferred):
            cache, logits = cache0, []
            for s in range(forced.shape[1]):
                lg, cache = fn(cfg, p, torch.from_numpy(forced[:, s]), cache,
                               impl="seqsharded")
                logits.append(_np(lg))
            out[fn.__name__] = (np.stack(logits), type(cache["k"]).__name__)
    return out


def moe_paths(rank, world, moe_args, train_args):
    """(6) on a (2, 2) mesh: ``apply_moe_ep`` at capacity 8.0 per MoE
    arch and the gradients of ``sum(y ** 2)`` with respect to the
    layer's leaves; one ``make_train_step(moe_impl="ep")`` step."""
    mesh = make_test_mesh(2, 2, device="cpu")
    set_mesh(mesh)
    out = {}
    for arch, (layer, x) in moe_args.items():
        cfg = reduced(arch)
        lp = _tensors(layer)
        x = torch.from_numpy(x)
        with torch.no_grad():
            y = _np(moe_mod.apply_moe_ep(lp, cfg, x, capacity_factor=8.0))
        leaves = {k: v.requires_grad_(True) for k, v in lp.items()
                  if not isinstance(v, dict)}
        with spmd_scope():
            loss = (moe_mod.apply_moe_ep(lp, cfg, x, capacity_factor=8.0)
                    ** 2).sum()
            grads = torch.autograd.grad(loss.full_tensor(),
                                        list(leaves.values()))
        out[arch] = (y, {k: g.numpy() for k, g in zip(leaves, grads)})

    # the trainer with moe_impl="ep": DTensor params, the batch on data
    arch, params, batch = train_args
    cfg = reduced(arch)
    p = M.params_from_jax(params, device="cpu")
    p = reshard(p, mesh, fit_specs(param_pspecs(cfg, p, fsdp=False), p,
                                   mesh))
    b = {k: to_dtensor(torch.from_numpy(v), mesh, P("data", None))
         for k, v in batch.items()}
    opt = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    p2, _, m = make_train_step(cfg, opt, moe_impl="ep")(p, init_adamw(p), b)
    out["ep_train"] = (float(_np(m["loss"])), float(_np(m["grad_norm"])),
                       tree_map(lambda t: type(t).__name__, p2))
    return out


def train_steps(rank, world, params, batch, microbatches, eps, mesh_shape):
    """(7): the gradients of the whole batch, then one
    ``make_train_step(microbatches=)`` at AdamW ``eps``, on reduced
    SmolLM's DTensor params (``param_pspecs(fsdp=False)``, non-dividing
    leaves replicated) on a ``mesh_shape`` mesh, the batch sharded on
    ``data``; rank 0 returns the loss, the grad norm, the new params,
    their types and the gradients."""
    mesh = make_test_mesh(*mesh_shape, device="cpu")
    cfg = reduced("smollm-360m")
    p = M.params_from_jax(params, device="cpu")
    p = reshard(p, mesh, fit_specs(param_pspecs(cfg, p, fsdp=False), p,
                                   mesh))
    b = {k: to_dtensor(torch.from_numpy(v), mesh, P("data", None))
         for k, v in batch.items()}
    # gathers are collectives: every rank takes part
    grads = tree_map(_np, value_and_grad(make_loss_fn(cfg))(p, b)[1])
    opt = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1, eps=eps)
    p2, _, m2 = make_train_step(cfg, opt, microbatches=microbatches)(
        p, init_adamw(p), b)
    placed = tree_map(lambda t: type(t).__name__, p2)
    out = (float(_np(m2["loss"])), float(_np(m2["grad_norm"])),
           tree_map(_np, p2), placed, grads)
    return out if rank == 0 else None
