#!/usr/bin/env python3
"""The control-plane counts of ``chip_smoke.py``'s swap workloads, on the
CPU, at full width, with the model's compute stubbed out.

A schedule does not depend on the tokens a model samples: admission,
preemption, swaps, prefix hits, demotions, fault draws and rollbacks
follow the scheduler, the cost model's virtual time and the workload's
prompts alone.  So this script builds the port's engine exactly as
``launch.serve.smoke_swap_server`` (TinyLlama-1.1B) and
``rwkv_smoke_server(preempt_mode="swap")`` (RWKV6-7B at 4 layers) do, but
with no weights and compute functions that return token 0 (the slot
plane's also advance each slot's index), and prints the counts of one
fault-free run and one per fault seed (``tests/test_chaos.py``'s MIXED
spec):

    PYTHONPATH=src python3 scripts/smoke_schedule.py [--seeds 1 2]

The pools hold bf16 zeros (about 90 MB for TinyLlama); a run takes about
a second.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (TheoreticalCostModel, get_hardware,  # noqa: E402
                              make_scheduler)
from repro_torch.data import zipf_shared_prefix  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.serving.faults import FaultSpec  # noqa: E402

MIXED = dict(p_alloc=0.05, p_store_transient=0.3, p_store_permanent=0.15,
             p_corrupt=0.2, p_demote_fail=0.3, p_promote_fail=0.3)


def stub_compute(eng: Engine) -> None:
    zeros = torch.zeros(eng.ecfg.nslots, dtype=torch.int32)
    if eng._pooled:
        eng._paged_prefill = lambda *a: zeros
        eng._paged_decode = lambda *a: zeros
        return

    def prefill(tokens, lengths):
        eng.cache["index"] += lengths.to(eng.cache["index"].dtype)
        return zeros

    def decode(tokens, active):
        eng.cache["index"] += active.to(eng.cache["index"].dtype)
        return zeros
    eng._prefill_many, eng._decode_many = prefill, decode


def build(which: str, faults):
    if which == "tinyllama":
        cfg = dataclasses.replace(get_config(S.SMOKE_ARCH), dtype="bfloat16")
        sched = make_scheduler("sarathi_cs", S.SMOKE_M,
                               S=S.SMOKE_ENGINE.cache_len, replacement="srf",
                               preempt_mode="swap", partial_preempt=True)
        ecfg = replace(S.SMOKE_SWAP_ENGINE, faults=faults)
        reqs = zipf_shared_prefix(**S.SMOKE_SWAP_WORKLOAD)
    else:
        cfg = dataclasses.replace(get_config(S.SMOKE_RWKV_ARCH),
                                  dtype="bfloat16", num_layers=4)
        sched = make_scheduler("vllm", S.SMOKE_RWKV_M,
                               S=S.SMOKE_RWKV_ENGINE.cache_len,
                               replacement="srf", preempt_mode="swap")
        ecfg = replace(S.SMOKE_RWKV_ENGINE, faults=faults)
        reqs = S.rwkv_smoke_requests(cfg.vocab_size)
    eng = Engine(cfg, None, sched, ecfg,
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device="cpu")
    stub_compute(eng)
    return eng, reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[1])
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    for which in ("tinyllama", "rwkv6-7b"):
        for seed in [None] + args.seeds:
            faults = None if seed is None else FaultSpec(seed=seed, **MIXED)
            t0 = time.perf_counter()
            eng, reqs = build(which, faults)
            res = eng.run(reqs)
            m = res.metrics
            what = "fault-free" if seed is None else f"MIXED seed {seed}"
            print(f"{which} {what} ({time.perf_counter() - t0:.1f} s): "
                  f"{len(m.batches)} "
                  f"batches, {eng.prefill_rounds} prefill rounds, "
                  f"{eng.decode_steps} decode steps, preemptions "
                  f"{m.num_preemptions} (partial {m.num_partial_preempts}), "
                  f"swaps {m.num_swaps}; recovery "
                  + str({k: v for k, v in res.recovery_stats.items()
                         if v and k != "wall_aborted_s"})
                  + "; swap counts "
                  + str({k: v for k, v in res.swap_stats.items()
                         if v and not k.startswith("wall_")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
