#!/usr/bin/env python3
"""How far RWKV6-7B with random weights amplifies fp32 rounding, on a card.

``python3 scripts/rwkv_sensitivity.py [--depths 2 4 8 16 32]``

The same prompts go through ``models.model.prefill`` (full width, fp32,
weights from seed 0, the WKV6 kernel) once as a batch of 1 and once as 4
identical rows: the rows' arithmetic differs only in the GEMMs' shape-
dependent summation order.  For the first ``d`` layers of the model, for
each depth ``d``, it prints the largest logit difference between the two
and how many prompts' greedy token flips; and for one prompt, the hidden
state's difference after each layer.  This is the noise floor of any
token-equality check between two batch shapes (the engine against
``generate_reference``), before any fault of the port.  Prompts are the
``rwkv_smoke_server`` workload's.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[2, 4, 8, 16, 32])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (SMOKE_RWKV_ARCH,
                                          rwkv_smoke_requests)
    from repro_torch.models import model as M

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(get_config(SMOKE_RWKV_ARCH), dtype="float32",
                              num_layers=max(args.depths))
    params = M.init_params(cfg, seed=0, device="cuda")
    prompts = [torch.tensor([r.prompt], device="cuda")
               for r in rwkv_smoke_requests(cfg.vocab_size)]
    V = cfg.vocab_size
    with torch.no_grad():
        for depth in args.depths:
            c = dataclasses.replace(cfg, num_layers=depth)
            p = dict(params, layers={k: v[:depth] for k, v in
                                     params["layers"].items()})
            worst, flips, gaps = 0.0, 0, []
            for toks in prompts:
                l1, _ = M.prefill(c, p, {"tokens": toks}, cache_len=0)
                l4, _ = M.prefill(c, p, {"tokens": toks.repeat(4, 1)},
                                  cache_len=0)
                worst = max(worst, (l4[:1] - l1).abs().max().item())
                flips += int(l1[0, :V].argmax() != l4[0, :V].argmax())
                top = torch.topk(l1[0, :V], 2).values
                gaps.append((top[0] - top[1]).item())
            print(f"depth {depth}: logits of 1 row vs 4 identical rows: max "
                  f"abs diff {worst:.3g}; greedy token flips {flips}/"
                  f"{len(prompts)}; smallest top-2 gap {min(gaps):.3g}")
        toks = prompts[0]
        x1 = params["embed"][toks]
        x4 = params["embed"][toks.repeat(4, 1)]
        for l, lp in enumerate(M.unstack_layers(params)):
            x1, _ = M._block_full(cfg, lp, x1, None, "reference", 0)
            x4, _ = M._block_full(cfg, lp, x4, None, "reference", 0)
            d, s = (x4[:1] - x1).abs().max().item(), x1.abs().max().item()
            print(f"  after layer {l + 1}: hidden max |x| {s:.3g}, 1 row vs "
                  f"4 rows max abs diff {d:.3g} (relative {d / s:.2g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
