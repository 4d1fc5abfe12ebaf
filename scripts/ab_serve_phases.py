#!/usr/bin/env python3
"""Run TinyLlama-1.1B's serving phases of ``chip_smoke.py`` for the tree
at ``--root`` on one NVIDIA card and print one JSON line (``AB {...}``):
phase 3 (the fp32 serve, tokens against ``generate_reference``), phase
21 in fp32 (the slot planes), phase 4 (the bf16 serve) and phase 21 in
bf16, each timed whole, their serves' walls, and the host-and-card time
of an eager ``decode_step`` (B 8, cache 512) and ``prefill_chunk`` (one
row, 64 tokens, cache 512) in both dtypes, 50 calls after 5.

The phases come from that tree's own ``chip_smoke.py`` and
``src/repro_torch``, so two trees compare on one card in one run, in
turns (parent, change, change, parent)::

    git archive <parent> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 scripts/ab_serve_phases.py --root $r --tag $r
    done

It builds B1 and B2 of that tree first.  Without a CUDA device it fails.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--root", required=True, help="root of the tree to run")
ap.add_argument("--tag", required=True, help="label of the JSON line")
args = ap.parse_args()
root = Path(args.root).resolve()
sys.path[:0] = [str(root / "src"), str(root)]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

assert Path(cs.__file__).resolve().parent == root, cs.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as pa  # noqa: E402,E501
from repro_torch.models import model as M  # noqa: E402

assert Path(repro_torch.__file__).resolve().is_relative_to(root), \
    repro_torch.__file__
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
t0 = time.perf_counter()
cuda_build.build([pa.DECODE_SRC, pa.PREFILL_SRC])
pa.build_all()
out = {"tag": args.tag, "card": card, "build_s": time.perf_counter() - t0}


def timed(name, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    out[name + "_s"] = time.perf_counter() - t
    return r


def eager(cfg, params, tag):
    """ms per eager call: decode_step at B 8 (cache 512) and prefill_chunk
    of 64 tokens for one row (cache 512), 50 calls each after 5."""
    cache = M.init_cache(cfg, 8, 512, device="cuda")
    tok = torch.zeros(8, dtype=torch.long, device="cuda")
    c1 = M.init_cache(cfg, 1, 512, device="cuda")
    chunk = torch.ones(1, 64, dtype=torch.long, device="cuda")
    for name, f in (
            ("decode_step", lambda: M.decode_step(cfg, params, tok, cache)),
            ("prefill_chunk",
             lambda: M.prefill_chunk(cfg, params, chunk, c1))):
        for _ in range(5):
            f()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        out[f"{name}_{tag}_ms"] = (time.perf_counter() - t) / 50 * 1e3


with torch.no_grad():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cuda")
    fp32 = timed("phase3_fp32",
                 lambda: cs.phase_serve_fp32(torch, pa, cfg, params))
    out["fp32_serve_wall_s"] = fp32["wall_s"]
    p32 = timed("phase21_fp32", lambda: cs.phase_planes(
        torch, pa, cfg, params, fp32["references"]))
    eager(cfg, params, "fp32")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params16 = cs._tree_to(params, torch.bfloat16)
    del params
    bf16 = timed("phase4_bf16",
                 lambda: cs.phase_serve_bf16(torch, pa, cfg16, params16))
    out["bf16_serve_wall_s"] = bf16["wall_s"]
    p16 = timed("phase21_bf16", lambda: cs.phase_planes(
        torch, pa, cfg16, params16, bf16["outputs"]))
    eager(cfg16, params16, "bf16")
    for tag, planes in (("fp32", p32), ("bf16", p16)):
        for name, r in planes.items():
            if isinstance(r, dict) and "wall_s" in r:
                out[f"{name}_{tag}_wall_s"] = r["wall_s"]
print("AB " + json.dumps(out, default=float), flush=True)
