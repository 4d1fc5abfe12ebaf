#!/usr/bin/env python3
"""Where bf16 leaves fp32, layer by layer, on each serving path of the
dense family, for every divergence that ``chip_smoke.py``'s phase 21
classed as a fault: a request whose bf16 tokens on a slot plane
(``batched``, ``deferred``, ``legacy``) leave the paged plane's at output
position p with an fp32 gap above the bf16 error's 99th percentile.

It reads ``chip_smoke.py --report``'s JSON: the paged plane's bf16
outputs (phase 4, ``serve_bf16``) and each slot plane's outputs and
margins (``planes_bf16``).  For each faulted request it feeds the prompt
and the p tokens both planes share, on full-width TinyLlama-1.1B with
``chip_smoke.py``'s bf16 weights (the seed-0 fp32 init cast to bf16),
through the paths of ``launch.margins.layer_states``:

* ``full``: the whole sequence at once (``prefill``'s reference blocks);
* ``slot``: the prompt 128 tokens at a time into a 512-slot cache, then
  one decode step per shared token with the reference decode attention
  (the ``deferred`` and ``legacy`` planes' decode);
* ``slot_b1``: the same with B1 on the dense view (the ``batched`` plane,
  ``impl="paged"``);
* ``paged``: the paged plane's own layers, B2 over 16-token pages, then
  one B1 decode step per shared token;

and the same weights in fp32 on the ``full`` path.  Per request it prints
the two planes' tokens at p, their fp32 gap (which must equal the
report's), each path's bf16 gap between them, its argmax, and one line
per layer with each path's relative error ||x - x_fp32|| / ||x_fp32|| at
the last position.  The engine's batch of 8 rows, its prefill buckets and
its preemptions are not replayed: a path's bits are its plane's only up
to B1's split over that batch and the chunks a schedule gives.

Run it on a card from the root of a checkout::

    python3 chip_smoke.py --report build/report.json
    python3 scripts/bf16_layer_errors.py --report build/report.json \\
        [--out build/layers.json]

Without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: path name -> (``layer_states`` path, decode attention ``impl``)
PATHS = {"full": ("full", "reference"), "slot": ("chunk", "reference"),
         "slot_b1": ("chunk", "paged"), "paged": ("paged", "reference")}
#: the slot planes of ``chip_smoke.py``'s phase 21 -> the path that runs
#: their arithmetic
PLANE_PATH = {"batched": "slot_b1", "deferred": "slot", "legacy": "slot"}


def faults(report):
    """{(rid, p): {"planes": [...], "shared": [...], "tokens": {plane or
    "paged": token at p}, "gap_fp32": {plane: the report's gap}}} of every
    divergence phase 21 classed as a fault."""
    paged = report["serve_bf16"]["outputs"]
    out = {}
    for plane, run in report["planes_bf16"].items():
        for rid, r in run["margins"]["requests"].items():
            if r["kind"] != "fault":
                continue
            p = r["pos"]
            shared = paged[rid][:p]
            if run["outputs"][rid][:p] != shared:
                raise ValueError(f"{plane} rid {rid}: the planes part "
                                 f"before position {p}")
            f = out.setdefault((int(rid), p), {
                "planes": [], "shared": shared, "gap_fp32": {},
                "tokens": {"paged": paged[rid][p]}})
            f["planes"].append(plane)
            f["tokens"][plane] = run["outputs"][rid][p]
            f["gap_fp32"][plane] = r["gap_fp32"]
    return dict(sorted(out.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", required=True,
                    help="chip_smoke.py --report's JSON")
    ap.add_argument("--out", help="also write the numbers here as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bf16_layer_errors: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch.margins import _cast, layer_states
    from repro_torch.launch.serve import (SMOKE_ARCH, SMOKE_ENGINE,
                                          SMOKE_WORKLOAD)
    from repro_torch.models import model as M
    from repro_torch.data.workloads import shared_prefix
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    todo = faults(json.loads(Path(args.report).read_text()))
    cfg32 = dataclasses.replace(get_config(SMOKE_ARCH), dtype="float32")
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params = _cast(M.init_params(cfg32, seed=0, device="cuda"),
                   torch.bfloat16)
    prompts = {r.rid: list(r.prompt) for r in shared_prefix(**dict(
        SMOKE_WORKLOAD, vocab=cfg32.vocab_size))}
    V = cfg32.vocab_size
    report = {"card": card, "requests": []}
    with torch.no_grad():
        for (rid, p), f in todo.items():
            P = len(prompts[rid])
            t = torch.tensor([prompts[rid] + f["shared"]], device="cuda")
            x32, l32 = layer_states(cfg32, params, t, dtype=torch.float32)
            l32 = l32[-1, :V]
            b = f["tokens"]["paged"]
            out = {"rid": rid, "pos": p, "prompt_len": P, **f,
                   "fp32_top2": torch.topk(l32, 2).indices.tolist(),
                   "gap_fp32_here": {}, "paths": {}}
            print(f"rid {rid}, output {p} ({P} prompt tokens + {p} shared)"
                  f": paged plane {b}; fp32 top-2 {out['fp32_top2']}")
            for plane in f["planes"]:
                a = f["tokens"][plane]
                g = (l32[a] - l32[b]).item()
                out["gap_fp32_here"][plane] = g
                print(f"  {plane} plane {a}: fp32 gap {g:+.4g} (the "
                      f"report's {f['gap_fp32'][plane]:+.4g})")
            rel = {}
            for name, (path, impl) in PATHS.items():
                xs, lg = layer_states(cfg16, params, t, path, prompt_len=P,
                                      cache_len=SMOKE_ENGINE.cache_len,
                                      impl=impl)
                lg = lg[-1, :V].float()
                rel[name] = [((x[-1] - y[-1]).norm() / y[-1].norm()).item()
                             for x, y in zip(xs, x32)]
                rec = {"argmax": int(lg.argmax()), "rel_last": rel[name],
                       "gaps": {pl: (lg[f["tokens"][pl]] - lg[b]).item()
                                for pl in f["planes"]}}
                out["paths"][name] = rec
                gaps = ", ".join(f"{pl} - paged {g:+.4g}"
                                 for pl, g in rec["gaps"].items())
                print(f"  {name:7s}: argmax {rec['argmax']}; bf16 gap "
                      f"{gaps}")
            print("  layer | " + " | ".join(PATHS) + "   (||x - x_fp32|| "
                  "/ ||x_fp32|| at the last position)")
            for layer in range(len(x32)):
                print(f"  {layer:5d} | " + " | ".join(
                    f"{rel[name][layer]:.3e}" for name in PATHS))
            report["requests"].append(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
