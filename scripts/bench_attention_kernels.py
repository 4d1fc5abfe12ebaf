#!/usr/bin/env python3
"""Time the attention kernels B2 (fused paged prefill) and B3 (flash
attention) of one source tree at the main path's shapes, in bf16 and fp32,
on one NVIDIA card: the timing of ``chip_smoke.py`` (CUDA events, L2
flushed before each launch) beside the plain version, SDPA and the bound.

It times the kernels of the tree given by ``--src`` (default: this
checkout's ``src/``), so two trees can be compared on one card in one run,
in turns (parent, change, change, parent)::

    git archive <parent> | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do
        python3 scripts/bench_attention_kernels.py --src $s
    done

Each run prints the card (``nvidia-smi`` name and power limit), one line
per kernel and shape, and, with ``--out PATH``, writes them as JSON.
Without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--out", help="also write the times here as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_attention_kernels: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.launch.serve import SMOKE_ENGINE, SMOKE_M
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; tree {src}")
    cuda_build.build([pa.PREFILL_SRC, fa.SRC])
    ecfg = SMOKE_ENGINE
    P = -(-SMOKE_M // ecfg.page_size) + 1
    inp = cs.Inputs(torch, 2)
    res = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            res[f"paged_prefill {dtype} serving round"] = cs.time_prefill(
                torch, pa, ref, cs.main_path_prefill(torch, inp, dtype, P,
                                                     ecfg), dtype)
            res[f"flash_attention {dtype} {cs.FLASH_MAIN}"] = cs.time_flash(
                torch, fa, fref, cs.flash_case(inp, *cs.FLASH_MAIN, dtype),
                dtype)
        res[f"flash_attention bfloat16 {cs.FLASH_LONG}"] = cs.time_flash(
            torch, fa, fref, cs.flash_case(inp, *cs.FLASH_LONG, "bfloat16"),
            "bfloat16")
    for what, t in res.items():
        print(f"{what}: {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
              f"sdpa {t['library_ms']:.4f} ms; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']})")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "src": str(src), "times": res}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
