"""Quickstart on the PyTorch port — the paper's pipeline in 60 seconds,
no card needed:

1. cost models for batch times (§4),
2. simulate schedulers under contention, NRF vs SRF replacement (§5, §8),
3. the five-minute rule for KV residency (§6),
4. a provably-optimal schedule from the CSP solver (§7).

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""
import sys

sys.path.insert(0, "src")

from repro_torch.configs import get_config
from repro_torch.core import (BatchSpec, TheoreticalCostModel,
                              break_even_table, fresh_requests, get_hardware,
                              run_sim, solve_optimal_schedule)

cfg = get_config("llama2-7b")
hw = get_hardware("a100")
cm = TheoreticalCostModel(cfg, hw, flops_eff=0.6, bw_eff=0.75,
                          attn_bw_eff=0.25)

# -- 1. cost model ------------------------------------------------------
spec = BatchSpec(prefills=[(512, 0)] * 4, decodes=[(1, 1024)] * 32)
print(f"hybrid batch (4 prefills of 512 + 32 decodes @ m=1024): "
      f"{cm.batch_time(spec)*1e3:.2f} ms predicted")

# -- 2. schedulers + replacement policies -------------------------------
print("\nW=256 identical requests (I=8, O=32), tight KV cache M=1000:")
for name, repl in [("vllm_pf", "pf"), ("vllm", "nrf"), ("vllm", "srf")]:
    reqs = fresh_requests([(8, 32, 0.0)] * 256)
    res = run_sim(name, reqs, cm, M=1000, replacement=repl)
    print(f"  {name:8s}/{repl}: latency {res.latency:7.2f}s  "
          f"preemptions {res.num_preemptions:5d}  "
          f"mean TTFT {res.mean_ttft:6.3f}s")

# -- 3. five-minute rule -------------------------------------------------
print("\nbreak-even KV residency (M=100K):")
for b in break_even_table(cm, M=100_000, ns=(1, 512, 32768)):
    print(f"  N={b.n_kvs:6d}: keep KVs resident if re-accessed within "
          f"{b.interval:8.2f}s")

# -- 4. optimal scheduling (CSP) -----------------------------------------
I, O, W = 4, 4, 4
M = max(2 * I, I + O - 1)
res = solve_optimal_schedule([(I, O)] * W, M=M, C=4096, cost_model=cm)
print(f"\nCSP optimum for W={W} x (I={I}, O={O}), M={M}: "
      f"{res.optimal_time*1e3:.2f} ms in {res.num_batches} batches, "
      f"using {res.num_preemptions} preemptions "
      f"(preemption IS optimal for short requests)")
