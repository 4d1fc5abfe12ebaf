"""Rank functions of ``tests/test_torch_spmd_engine.py``: the port's
``Engine`` over a mesh of ``gloo`` CPU ranks
(``repro_torch.launch.mesh.run_ranks``).  Imports the port only (no JAX
in the ranks); weights and requests cross as numpy arrays and lists, and
results come back as plain Python values."""
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import Request, TheoreticalCostModel, get_hardware
from repro_torch.core import make_scheduler
from repro_torch.distributed.context import set_mesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig


def reduced(name: str):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32")


def summary(eng, res) -> dict:
    """What the test compares: tokens, the ``BatchLog`` schedule without
    its measured wall, and every count but the measured ``wall_*``."""
    logs = []
    for b in res.metrics.batches:
        d = dataclasses.asdict(b)
        d.pop("wall_s")
        logs.append(d)
    m = res.metrics
    return {
        "outputs": {int(k): list(v) for k, v in res.outputs.items()},
        "logs": logs,
        "swap": {k: v for k, v in res.swap_stats.items()
                 if not k.startswith("wall_")},
        "recovery": {k: v for k, v in res.recovery_stats.items()
                     if k != "wall_aborted_s"},
        "metrics": dict(preemptions=m.num_preemptions,
                        partial=m.num_partial_preempts, swaps=m.num_swaps),
        "num_graphs": eng.num_graphs,
        "eager_calls": eng.graphs.eager_calls,
        "cache_types": sorted({type(v).__name__
                               for v in (eng.cache or {}).values()}),
        "expert_types": sorted({type(v).__name__ for v in
                                eng.params["layers"].get("moe", {}).values()
                                if not isinstance(v, dict)}),
        "requeue_steps": list(getattr(eng, "requeue_steps", [])),
    }


def make_engine(cfg, params, case: dict):
    """The engine of one case: ``case`` holds the scheduler's M, S and
    preemption mode and the ``EngineConfig`` fields."""
    ekw = dict(case["engine"])
    sched = make_scheduler(case.get("sched", "vllm"), case["M"],
                           S=case["S"], replacement="srf",
                           preempt_mode=case.get("preempt_mode",
                                                 "recompute"))
    return Engine(cfg, params, sched, EngineConfig(**ekw),
                  cost_model=TheoreticalCostModel(cfg,
                                                  get_hardware("tpu_v5e")),
                  device="cpu")


def _requests(spec):
    return [Request(rid=i, input_len=n_in, output_len=n_out, arrival=a,
                    prompt=list(p)) for i, n_in, n_out, a, p in spec]


def _slow_rank(eng, rank: int, case: dict) -> None:
    """The straggler case: rank ``case["slow_rank"]`` sleeps
    ``case["sleep_s"]`` inside the decode of step ``case["slow_step"]``,
    which the step's measured wall includes; every rank records the steps
    at which it requeues (``requeue_steps``)."""
    eng.requeue_steps = []
    requeue = eng._requeue_stragglers

    def record():
        eng.requeue_steps.append(eng._step_no)
        requeue()
    eng._requeue_stragglers = record
    if rank != case["slow_rank"]:
        return
    decode = eng._run_decodes_batched

    def slow(items):
        if eng._step_no == case["slow_step"]:
            time.sleep(case["sleep_s"])
        return decode(items)
    eng._run_decodes_batched = slow


def serve_cases(rank, world, mesh_shape, cases):
    """Every case on one mesh: ``cases`` maps a name to (arch, params as
    numpy, request spec, settings).  Also each setting's refusal without
    a mesh, before the mesh is set."""
    out = {}
    for name, (arch, params, spec, case) in cases.items():
        cfg = reduced(arch)
        p = M.params_from_jax(params, device="cpu")
        if name == next(iter(cases)):
            try:
                make_engine(cfg, p, case)
                out["no_mesh"] = None
            except ValueError as e:
                out["no_mesh"] = str(e)
            set_mesh(make_test_mesh(*mesh_shape, device="cpu"))
        eng = make_engine(cfg, p, case).warmup()
        if "slow_rank" in case:
            _slow_rank(eng, rank, case)
        t0 = time.perf_counter()
        res = eng.run(_requests(spec))
        out[name] = dict(summary(eng, res),
                         seconds=time.perf_counter() - t0)
    out["moe_replicated"] = moe_replicated()
    set_mesh(None)
    return out


def moe_replicated(capacity_factor: float = 1.0):
    """``apply_moe_ep`` on decode-shaped tokens (replicated over the
    expert axis) at a capacity where rows overflow: (this rank's output,
    the dense dispatch's), as numpy."""
    import torch
    from repro_torch.models import moe as moe_mod
    cfg = reduced("qwen2-moe-a2.7b")
    gen = torch.Generator()
    gen.manual_seed(0)
    lp = moe_mod.init_moe(gen, cfg, torch.float32)
    x = torch.randn((8, 1, cfg.d_model), generator=gen)
    with torch.no_grad():
        y = moe_mod.apply_moe_ep(lp, cfg, x, capacity_factor=capacity_factor)
        return y.to_local().numpy(), moe_mod.apply_moe(lp, cfg, x).numpy()
