"""InferMax-style what-if analysis (§2, Fig. 1) on the PyTorch port:
explore hardware and policy changes purely in the cost model — no card
needed.

  * What if GPU memory shrinks (multi-tenancy)?  -> preemption wins grow.
  * What if HBM bandwidth doubles (future GPUs)? -> decode-bound batches
    speed up ~2x, SLO pareto widens.
  * Which (c, m) keep TPOT under 100 ms on each hardware?

Run:  PYTHONPATH=src python examples/torch_whatif_analysis.py
"""
import dataclasses
import sys

sys.path.insert(0, "src")

from repro_torch.configs import get_config
from repro_torch.core import (BatchSpec, TheoreticalCostModel,
                              fresh_requests, get_hardware, run_sim)
from repro_torch.core.slo import pareto_curve

cfg = get_config("llama2-7b")
base_hw = get_hardware("a100")
CAL = dict(flops_eff=0.6, bw_eff=0.75, attn_bw_eff=0.25)

# -- what if memory shrinks (multi-tenancy)? -----------------------------
print("multi-tenancy: shrinking KV cache M (W=512, I=8, O=32)")
cm = TheoreticalCostModel(cfg, base_hw, **CAL)
for M in (50_000, 5_000, 500):
    pf = run_sim("vllm_pf", fresh_requests([(8, 32, 0.0)] * 512), cm, M=M)
    npf = run_sim("vllm", fresh_requests([(8, 32, 0.0)] * 512), cm, M=M)
    better = "preemption" if npf.latency < pf.latency else "PF"
    print(f"  M={M:6d}: vllm {npf.latency:7.2f}s vs PF {pf.latency:7.2f}s "
          f"-> {better} wins")

# -- what if bandwidth doubles (future GPUs)? ----------------------------
print("\nbandwidth scaling on a decode-heavy batch "
      "(128 decodes @ m=4096):")
spec = BatchSpec(decodes=[(1, 4096)] * 128)
for mult in (1.0, 2.0, 4.0):
    hw = dataclasses.replace(base_hw, hbm_bw=base_hw.hbm_bw * mult)
    t = TheoreticalCostModel(cfg, hw, **CAL).batch_time(spec)
    print(f"  {mult:.0f}x HBM bandwidth: batch time {t*1e3:7.2f} ms")
print("  -> near-linear: decode is bandwidth-bound (the paper's "
      "'memory wall')")

# -- SLO pareto per hardware ---------------------------------------------
print("\nlargest decode context m with TPOT <= 100 ms "
      "(8 prefills of c, 32 decodes):")
for hw_name in ("a100", "h100", "tpu_v5e"):
    cm = TheoreticalCostModel(cfg, get_hardware(hw_name), **CAL)
    pts = pareto_curve(cm, num_prefill=8, num_decode=32, threshold=0.1,
                       cs=(64, 1024))
    desc = ", ".join(f"c={p.c}: m<={p.m}" for p in pts) or "infeasible"
    print(f"  {hw_name:8s}: {desc}")
