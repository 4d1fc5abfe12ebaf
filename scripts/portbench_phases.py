#!/usr/bin/env python3
"""The serving step by phase, in runs of the port's benchmark.

    python3 scripts/portbench_phases.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1> [--root DIR] [--out PATH]

Runs one cell as ``python3 -m portbench.run`` does (``run_cell`` of the
tree at ``--root``: its ``src`` and its ``portbench``; default this
checkout) and reports, beside its result, what the harness does not
print:

* the window's ``Engine.phase_stats`` in host ms a step, one key a span
  (a tree before the spans has three keys), with the graph replays and
  the prefill counters where the engine has them; in a traced run also
  over the traced sub-window alone.  Printed to standard error in both
  kinds of run;
* in a traced run, from the device trace of the sub-window: host ms a
  step by program span, idle seconds by the innermost span around them,
  the longest idle gaps named by harness range, program
  spans and host operation (``portbench.program_spans``), and every
  device interval that carries a program span's name (an echo: there
  should be none);
* Python's garbage collections in the window: count and longest pause
  by generation; while the profiler collects, each is a range named
  ``gc.gen<n>``, so a gap it causes is named by it.

Writes the report as one JSON object to ``--out`` (default
``build/phases/<cell>.<seed>.<trace>.json``, a directory git ignores)
and prints it as the last line.  Exits 2 without a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
COUNTERS = ("prefill_rounds", "decode_steps", "prefill_tokens",
            "prefill_grid_tokens")


def snapshot(eng) -> dict:
    out = {k: float(v) for k, v in eng.phase_stats.items()}
    out["replays"] = float(eng.graphs.replays)
    for k in COUNTERS:
        if hasattr(eng, k):
            out[k] = float(getattr(eng, k))
    return out


def per_step(after: dict, before: dict, steps: int) -> dict:
    """Moves of the counters a step; the ``_s`` keys as ms a step."""
    out = {"steps": steps}
    for k, v in after.items():
        d = v - before.get(k, 0.0)
        out[k[:-2] + "_ms" if k.endswith("_s") else k] = \
            (1e3 * d if k.endswith("_s") else d) / max(steps, 1)
    return out


class GcPauses:
    """``gc.callbacks`` hook: pauses by generation, and a profiler range
    around each collection while a profiler collects."""

    def __init__(self):
        self.pauses: dict = {}
        self.t0 = 0.0
        self.rf = None

    def __call__(self, phase, info):
        import torch
        from torch.autograd import profiler
        if phase == "start":
            self.t0 = time.perf_counter()
            if profiler._is_profiler_enabled:
                self.rf = torch._C._profiler._RecordFunctionFast(
                    f"gc.gen{info['generation']}")
                self.rf.__enter__()
            return
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        n, worst = self.pauses.get(info["generation"], (0, 0.0))
        self.pauses[info["generation"]] = (
            n + 1, max(worst, time.perf_counter() - self.t0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    from portbench import run as R
    from portbench import serve as S
    from portbench import trace as T
    R.setup_paths()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from portbench.spec import load_cell

    held: dict = {}
    pauses = GcPauses()
    drive, start, finish = S.Driver.run, T.Tracer.start, T.Tracer.finish

    def run(self):
        held["drv"] = self
        before = snapshot(self.eng)
        gc.callbacks.append(pauses)
        try:
            rec = drive(self)
        finally:
            gc.callbacks.remove(pauses)
            del held["drv"]          # the engine must go before the check
        held["window"] = per_step(snapshot(self.eng), before,
                                  len(rec.step_walls))
        if "at_trace" in held:
            snap, n0 = held.pop("at_trace")
            held["sub_window"] = per_step(snapshot(self.eng), snap,
                                          len(rec.step_walls) - n0)
        return rec

    def tracer_start(self):
        drv = held["drv"]
        held["at_trace"] = (snapshot(drv.eng), len(drv.rec.step_walls))
        start(self)

    def tracer_finish(self):
        held["trace"] = finish(self)
        return held["trace"]

    S.Driver.run, T.Tracer.start, T.Tracer.finish = \
        run, tracer_start, tracer_finish
    cell = load_cell(args.workload)
    res = R.run_cell(cell, args.seed, args.seconds, bool(args.trace))
    report = {"workload": args.workload, "seed": args.seed,
              "trace": args.trace, "root": str(root),
              "correct": res["correct"], "metrics": res["metrics"],
              "device": res["device"], "window": held.get("window"),
              "gc_pauses": {f"gen{g}": {"count": n, "max_s": w}
                            for g, (n, w) in sorted(pauses.pauses.items())}}
    print(f"phase_stats a step, window: {held.get('window')}",
          file=sys.stderr)
    data = held.get("trace")
    if data is not None:
        report["sub_window"] = held.get("sub_window")
        print(f"phase_stats a step, traced sub-window: "
              f"{held.get('sub_window')}", file=sys.stderr)
        try:
            from portbench import program_spans as P
        except ImportError:
            P = None
        if P is not None:
            names = sorted({h[0] for h in P.program(data)})
            report["span_ms_per_step"] = {
                n: P.per_step_ms(data, n) for n in names}
            report["idle_by_span_s"] = P.idle_by_span(data)
            report["gaps"] = P.gap_labels(data, k=15)
            report["echoes"] = sorted({n for n, _, _ in data.device
                                       if n.startswith(P.PREFIX)})
        report["busy_s"] = data.busy_s()
        report["window_s"] = data.window_s
        report["breakdown_gaps"] = data.idle_gaps()
    out = Path(args.out) if args.out else \
        HERE / "build" / "phases" / \
        f"{args.workload}.{args.seed}.{args.trace}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
