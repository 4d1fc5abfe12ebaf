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
* the step graphs' capture seconds in set-up (``StepGraphs.capture_s``)
  and their count;
* the window's prefill rounds by the rows of their grid
  (``prefill_rounds_by_rows``: the row rung on the pooled plane) and its
  pad share, 100 x (1 - ``prefill_tokens`` / ``prefill_grid_tokens``),
  where the engine has the counters;
* in a traced run, from the device trace of the sub-window: host ms a
  step by program span, idle seconds by the innermost span around them,
  the longest idle gaps named by harness range, program
  spans and host operation (``portbench.program_spans``), and every
  device interval that carries a program span's name (an echo: there
  should be none);
* Python's garbage collections in the window: count, longest and total
  pause by generation; while the profiler collects, each is a range named
  ``gc.gen<n>``, so a gap it causes is named by it;
* the grouped MoE dispatch's row accumulators over the whole run, read
  once at its end (``moe_grouped.ops.row_counters`` of
  ``Engine.moe_stats``: ``moe_routed_rows``, ``moe_experts_reached_share``,
  ``moe_expert_load_max_over_mean``, and the share by layer), where the
  engine has them;
* what the engine holds at the window's end and grows with the requests
  it finished: the pool's live pages, those in block tables and those in
  the prefix registry alone, the registry's trie nodes, the requests
  whose token ids it keeps; and the host ms a step of the step
  transaction's snapshot (``Engine._begin_txn``), over the window and
  over its first and last fifth of steps.

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
BY_ROWS = "prefill_rounds_by_rows"


def snapshot(eng) -> dict:
    out = {k: float(v) for k, v in eng.phase_stats.items()}
    out["replays"] = float(eng.graphs.replays)
    for k in COUNTERS:
        if hasattr(eng, k):
            out[k] = float(getattr(eng, k))
    for rows, n in getattr(eng, BY_ROWS, {}).items():
        out[f"{BY_ROWS}.{rows}"] = float(n)
    return out


def prefill_summary(after: dict, before: dict) -> dict:
    """The rounds run between two snapshots by their grid's rows, and the
    pad share of their grids in %, where the engine counts them."""
    out = {}
    rounds = {int(k.split(".")[1]): int(v - before.get(k, 0.0))
              for k, v in after.items() if k.startswith(BY_ROWS + ".")}
    if rounds:
        out[BY_ROWS] = {r: n for r, n in sorted(rounds.items()) if n}
    grid = after.get("prefill_grid_tokens", 0.0) \
        - before.get("prefill_grid_tokens", 0.0)
    if grid > 0:
        real = after["prefill_tokens"] - before.get("prefill_tokens", 0.0)
        out["pad_share_pct"] = 100.0 * (1.0 - real / grid)
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
        dt = time.perf_counter() - self.t0
        n, worst, total = self.pauses.get(info["generation"], (0, 0.0, 0.0))
        self.pauses[info["generation"]] = (n + 1, max(worst, dt),
                                           total + dt)


class TxnTimes:
    """Host seconds of each ``Engine._begin_txn`` call, in call order."""

    def __init__(self, cls):
        self.times: list = []
        begin = cls._begin_txn

        def timed(eng):
            t0 = time.perf_counter()
            try:
                return begin(eng)
            finally:
                self.times.append(time.perf_counter() - t0)
        cls._begin_txn = timed

    def summary(self, n0: int) -> dict:
        """ms a call from the ``n0``-th on, and over its first and last
        fifth."""
        t = self.times[n0:]
        if not t:
            return {}
        k = max(1, len(t) // 5)
        return {"calls": len(t), "ms": 1e3 * sum(t) / len(t),
                "first_fifth_ms": 1e3 * sum(t[:k]) / k,
                "last_fifth_ms": 1e3 * sum(t[-k:]) / k}


def held_state(eng) -> dict:
    """What the engine holds that grows with the requests it finished."""
    alloc = eng.allocator
    reg = alloc.prefix_cache
    return {"pool_pages": alloc.num_pages, "used_pages": alloc.used_pages,
            "table_pages": alloc.table_pages,
            "registry_pages": len(reg.pages),
            "registry_only_pages": alloc.used_pages - alloc.table_pages,
            "registry_nodes": reg.num_nodes,
            "requests_held": len(eng.token_ids)}


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
    from repro_torch.kernels.moe_grouped.ops import row_counters
    from repro_torch.serving.engine import Engine
    txn = TxnTimes(Engine)
    drive, start, finish = S.Driver.run, T.Tracer.start, T.Tracer.finish

    def run(self):
        held["drv"] = self
        held["capture_s"] = self.eng.graphs.capture_s
        held["num_graphs"] = self.eng.num_graphs
        before = snapshot(self.eng)
        n0 = len(txn.times)
        gc.callbacks.append(pauses)
        try:
            rec = drive(self)
        finally:
            gc.callbacks.remove(pauses)
            del held["drv"]          # the engine must go before the check
        after = snapshot(self.eng)
        held["held_at_end"] = dict(held_state(self.eng),
                                   finished=len(self.finished()))
        held["begin_txn"] = txn.summary(n0)
        held["window"] = per_step(after, before, len(rec.step_walls))
        held["prefill"] = prefill_summary(after, before)
        held["counters"] = dict(rec.counters)
        held["moe"] = row_counters(getattr(self.eng, "moe_stats", None),
                                   self.eng.cfg.num_experts)
        if "at_trace" in held:
            snap, n0 = held.pop("at_trace")
            held["sub_window"] = per_step(after, snap,
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
              "prefill": held.get("prefill"), "moe": held.get("moe"),
              "counters": held.get("counters"),
              "capture_s": held.get("capture_s"),
              "num_graphs": held.get("num_graphs"),
              "held_at_end": held.get("held_at_end"),
              "begin_txn": held.get("begin_txn"),
              "gc_pauses": {f"gen{g}": {"count": n, "max_s": w,
                                        "total_s": t}
                            for g, (n, w, t)
                            in sorted(pauses.pauses.items())}}
    print(f"phase_stats a step, window: {held.get('window')}",
          file=sys.stderr)
    print(f"prefill rounds by grid rows and pad share, window: "
          f"{held.get('prefill')}", file=sys.stderr)
    print(f"grouped MoE row accumulators, whole run: {held.get('moe')}",
          file=sys.stderr)
    print(f"held at the window's end: {held.get('held_at_end')}; step "
          f"snapshot: {held.get('begin_txn')}; gc: {report['gc_pauses']}",
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
        report["device_ops"] = data.top_ops(20)
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
