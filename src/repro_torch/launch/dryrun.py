"""Multi-pod dry run: the counterpart of ``repro.launch.dryrun``.

Runs one step of an (architecture x input shape) cell on a production
mesh of 256 or 512 ranks WITHOUT a card or any real array: the ranks are
a ``fake`` process group (``FakeStore``; this process plays rank 0), the
mesh is ``launch.mesh.make_production_mesh`` on it, and params, caches
and batches are meta DTensors placed by ``distributed.sharding``'s
``param_pspecs`` / ``batch_pspecs`` / ``out_pspecs_decode``.  The step
(train, prefill or decode) runs once under ``comm_analysis.
StepRecorder``, which records each rank-local op beneath DTensor.

For every cell it records, per device (rank 0's shard of each tensor):

* ``argument_bytes``: the inputs' local bytes (params, optimizer state,
  cache, batch), from the DTensors' local shapes;
* ``flops``: the local ops' FLOPs (``torch.utils.flop_counter``'s
  formulas on the local shapes);
* ``unfused_op_bytes``: the bytes every local op reads and writes
  (views excluded), an eager, unfused count of memory traffic;
* the collectives (``comm_analysis.collective_bytes``) and the three
  roofline terms against an H100 (``core.cost_model.get_hardware("h100")``,
  80 GB), and the dominant one.

Differences from JAX's report, each deliberate: the hardware is the H100
(JAX prices a TPU v5e); XLA's ``bytes accessed`` (after fusion),
``temp_bytes`` and ``bytes_tpu`` have no PyTorch counterpart, so the
memory term reads ``unfused_op_bytes`` and the working set comes from
``analytic_memory`` alone, as JAX's ``fits_hbm`` does; and a decode
cell with a sequence-sharded cache runs ``impl="seqsharded"`` by
default, since the reference decode's in-place row write cannot run on a
sharded DTensor (GSPMD partitions it; DTensor refuses).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k
  python -m repro_torch.launch.dryrun --all --multi-pod --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cost_model import get_hardware
from repro_torch.launch.comm_analysis import StepRecorder, collective_bytes

HW = get_hardware("h100")
#: where ``main`` writes its JSON unless told otherwise (git-ignored)
DEFAULT_OUT = os.path.join("build", "dryrun")


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode D = batch
    tokens; train counts fwd+bwd (6ND), inference counts fwd (2ND)."""
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * 1 * shape.global_batch  # decode: one token per request


def analytic_memory(cfg: ModelConfig, shape: ShapeConfig, chips: int, *,
                    fsdp: bool, microbatches: int = 1) -> Dict[str, float]:
    """TPU-side HBM estimate per chip (the CPU backend's temp analysis
    reflects host scheduling, not TPU buffer assignment).

    train: bf16 params + fp32 (master, mu, nu) + fp32 grads, all sharded
    over the whole mesh when fsdp else over model only; activations with
    remat ~= residual stream for all layers + one layer's working set.
    serve: bf16 params over model axis + the KV cache over the mesh.
    """
    n = cfg.num_params()
    model_par = 16
    mesh_par = chips if fsdp else model_par
    if shape.kind == "train":
        weights = 2 * n / mesh_par                # bf16
        opt = 3 * 4 * n / mesh_par                # fp32 master+mu+nu
        grads = 4 * n / mesh_par
        B_loc = shape.global_batch / (chips / model_par) / microbatches
        d_wide = max(cfg.d_ff, cfg.q_dim + 2 * cfg.kv_dim,
                     2 * cfg.d_inner if cfg.ssm_state else 0)
        acts = B_loc * shape.seq_len * (
            cfg.num_layers * cfg.d_model * 2            # bf16 stream
            + 6 * d_wide / model_par * 2)               # one layer, TP
        logits = B_loc * shape.seq_len * cfg.padded_vocab / model_par * 4
        total = weights + opt + grads + acts + logits
        return {"weights": weights, "opt": opt + grads, "acts": acts,
                "logits": logits, "total": total}
    weights = 2 * n / model_par
    B, S = shape.global_batch, shape.seq_len
    eff = min(S, cfg.window) if cfg.window else S
    kv = (cfg.num_layers * B * eff * 2 * cfg.kv_dim * 2) / chips
    if cfg.family == "ssm":
        kv = cfg.num_layers * B * (cfg.ssm_heads * cfg.ssm_state ** 2 * 4
                                   + 2 * cfg.d_model * 2) / chips
    acts = (B * S * cfg.d_model * 2 / (chips / model_par)
            if shape.kind == "prefill" else B * cfg.d_model * 2)
    total = weights + kv + acts
    return {"weights": weights, "kv": kv, "acts": acts, "total": total}


# --------------------------------------------------------------------- #
# meta DTensors
# --------------------------------------------------------------------- #


def _meta(shape, dtype, mesh, spec):
    """A meta DTensor of global ``shape`` under ``spec``: rank 0's local
    block, allocating nothing."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.distributed.context import placements
    pl = placements(mesh, spec)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _placed(tree, specs, mesh):
    """A tree of shape-only tensors as meta DTensors under ``specs``."""
    if isinstance(tree, dict):
        return {k: _placed(v, specs[k], mesh) for k, v in tree.items()}
    return _meta(tuple(tree.shape), tree.dtype, mesh, specs)


def _local_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return 0
    local = tree.to_local() if hasattr(tree, "to_local") else tree
    return local.numel() * local.element_size()


def _inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``repro.serving.serve_step.serve_input_specs``: the cell's inputs
    as shape-only tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.model import _dtype
    from repro_torch.serving.serve_step import cache_specs
    B, S = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        if shape.kind == "decode":
            return {"tokens": torch.empty((B,), dtype=torch.int32),
                    "cache": cache_specs(cfg, B, S)}
        specs = {"tokens": torch.empty((B, S), dtype=torch.int32)}
        if shape.kind == "train":
            specs["labels"] = torch.empty((B, S), dtype=torch.int32)
        if cfg.frontend == "patch":
            specs["patch_embeds"] = torch.empty(
                (B, cfg.num_patches, cfg.d_model), dtype=_dtype(cfg))
        return specs


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               impl: str = "reference", moe_impl: str = "sparse",
               remat: bool = True, seq_shard: bool = True,
               fsdp: bool = True, microbatches: int = 1,
               append: str = "inline"):
    """Returns (step, args as meta DTensors, output placer): ``step(*args)``
    runs the cell's step once; the placer takes its outputs to the
    output specs (JAX's ``out_shardings``)."""
    from repro_torch.distributed.context import P, dp_axes_of, to_dtensor
    from repro_torch.distributed.sharding import (batch_pspecs, fit_specs,
                                                  out_pspecs_decode,
                                                  param_pspecs)
    from repro_torch.models import model as M
    from repro_torch.serving.serve_step import param_specs
    pshape = param_specs(cfg)
    ps = fit_specs(param_pspecs(cfg, pshape,
                                fsdp=fsdp and shape.kind == "train"),
                   pshape, mesh)
    params = _placed(pshape, ps, mesh)
    ins = _inputs(cfg, shape)
    bspec = batch_pspecs(cfg, shape, mesh, seq_shard=seq_shard)

    def place(tree, specs):
        if isinstance(tree, dict):
            return {k: place(v, specs[k]) for k, v in tree.items()}
        return to_dtensor(tree, mesh, specs)

    if shape.kind == "train":
        from repro_torch.training.optimizer import AdamWConfig, init_adamw
        from repro_torch.training.train_step import make_train_step
        batch = {k: _placed(v, bspec[k], mesh) for k, v in ins.items()}
        opt = init_adamw(params)
        step = make_train_step(cfg, AdamWConfig(total_steps=1000),
                               microbatches=microbatches, impl=impl,
                               moe_impl=moe_impl, remat=remat)
        return step, (params, opt, batch), lambda out: out
    if shape.kind == "prefill":
        batch = {k: _placed(v, bspec[k], mesh) for k, v in ins.items()}
        dshape = dataclasses.replace(shape, kind="decode")
        cache_spec = batch_pspecs(cfg, dshape, mesh,
                                  seq_shard=seq_shard)["cache"]
        out_spec = (P(dp_axes_of(mesh), "model"), cache_spec)

        def prefill(p, b):
            with torch.no_grad():
                return M.prefill(cfg, p, b, cache_len=shape.seq_len,
                                 impl=impl, moe_impl=moe_impl)
        return prefill, (params, batch), lambda out: (
            place(out[0], out_spec[0]), place(out[1], out_spec[1]))
    tokens = _placed(ins["tokens"], bspec["tokens"], mesh)
    cache = _placed(ins["cache"], bspec["cache"], mesh)
    out_spec = out_pspecs_decode(cfg, shape, mesh, seq_shard=seq_shard)
    fn = M.decode_step_deferred if append == "deferred" else M.decode_step

    def decode(p, t, c):
        with torch.no_grad():
            return fn(cfg, p, t, c, impl=impl, moe_impl=moe_impl)
    return decode, (params, tokens, cache), lambda out: (
        place(out[0], out_spec[0]), place(out[1], out_spec[1]))


def _start_ranks(chips: int) -> None:
    """This process as rank 0 of a ``fake`` group of ``chips`` ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                impl: Optional[str] = None, moe_impl: str = "sparse",
                remat: bool = True, seq_shard: bool = True,
                fsdp: bool = True, microbatches: int = 1,
                append: str = "inline",
                verbose: bool = True) -> Dict[str, Any]:
    import torch.distributed as dist
    from repro_torch.distributed.context import set_mesh
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if impl is None:
        impl = ("seqsharded" if shape.kind == "decode" and seq_shard
                and cfg.num_heads else "reference")
    chips = 512 if multi_pod else 256
    if shape.kind == "train" and microbatches == 0:  # auto: fit HBM
        microbatches = 1
        while (analytic_memory(cfg, shape, chips, fsdp=fsdp,
                               microbatches=microbatches)["total"]
               > 0.9 * HW.hbm_cap and microbatches < 32):
            microbatches *= 2
    microbatches = max(1, microbatches)
    t0 = time.time()
    _start_ranks(chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        set_mesh(mesh)
        step, args, place = build_cell(
            cfg, shape, mesh, impl=impl, moe_impl=moe_impl, remat=remat,
            seq_shard=seq_shard, fsdp=fsdp, microbatches=microbatches,
            append=append)
        t_build = time.time() - t0
        # a first, unrecorded step fills DTensor's sharding-propagation
        # caches: the recorded one then runs only the ranks' local ops
        place(step(*args))
        t_step = time.time() - t0 - t_build
        rec = StepRecorder()
        with rec:
            out = place(step(*args))
        arg_bytes = _local_bytes(args)
        out_bytes = _local_bytes(out)
    finally:
        set_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()

    colls = collective_bytes(rec.log)
    flops_dev = float(rec.flops)
    compute_s = flops_dev / HW.flops
    memory_s = rec.op_bytes / HW.hbm_bw
    collective_s = colls.link_bytes / HW.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / (flops_dev * chips) if flops_dev else 0.0

    report = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "hardware": HW.name,
        "impl": impl, "moe_impl": moe_impl, "remat": remat,
        "seq_shard": seq_shard, "fsdp": fsdp, "microbatches": microbatches,
        "append": append,
        "build_s": round(t_build, 1), "step_s": round(t_step, 1),
        "per_device": {
            "flops": flops_dev, "unfused_op_bytes": rec.op_bytes,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        },
        "collectives": {
            "bytes_by_kind": colls.bytes_by_kind,
            "count_by_kind": colls.count_by_kind,
            "link_bytes_per_device": colls.link_bytes,
        },
        "roofline": {
            **{k: float(v) for k, v in terms.items()},
            "dominant": dominant,
            "model_flops": mf,
            "useful_flops_fraction": useful,
        },
    }
    amem = analytic_memory(cfg, shape, chips, fsdp=fsdp,
                           microbatches=microbatches)
    report["analytic_memory_per_chip"] = amem
    report["fits_hbm"] = bool(amem["total"] <= HW.hbm_cap)
    if verbose:
        print(f"[dryrun] {arch:20s} {shape_name:12s} {report['mesh']:8s} "
              f"args={arg_bytes / 1e9:6.2f}GB "
              f"hbm~{amem['total'] / 1e9:6.2f}GB "
              f"C={compute_s*1e3:9.3f}ms M={memory_s*1e3:9.3f}ms "
              f"X={collective_s*1e3:9.3f}ms dom={dominant:12s} "
              f"useful={useful:5.1%} (build {t_build:.0f}s "
              f"step {t_step:.0f}s)", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--impl", default=None,
                    help="default: seqsharded for a decode cell with a "
                    "sequence-sharded cache, else reference")
    ap.add_argument("--moe-impl", default="sparse")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="grad-accumulation microbatches (0 = auto-fit HBM)")
    ap.add_argument("--decode-append", default="inline",
                    choices=["inline", "deferred"])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSON output directory (git-ignored by default)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ASSIGNED_ARCHS:
            for sh in applicable_shapes(get_config(arch)):
                cells.append((arch, sh))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = []
    for arch, sh in cells:
        for mp in meshes:
            try:
                rep = dryrun_cell(
                    arch, sh, multi_pod=mp, impl=args.impl,
                    moe_impl=args.moe_impl, remat=not args.no_remat,
                    seq_shard=not args.no_seq_shard, fsdp=not args.no_fsdp,
                    microbatches=args.microbatches,
                    append=args.decode_append)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    tag = "mp" if mp else "sp"
                    path = os.path.join(args.out, f"{arch}_{sh}_{tag}.json")
                    with open(path, "w") as f:
                        json.dump(rep, f, indent=1)
            except Exception as e:  # noqa: BLE001 - report-all mode
                failures.append((arch, sh, mp, repr(e)))
                print(f"[dryrun] FAIL {arch} {sh} mp={mp}: {e!r}",
                      flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES")
        return 1
    print("[dryrun] all cells ran OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
