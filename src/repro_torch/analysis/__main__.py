"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit code 0 iff no blocking findings (not suppressed inline, not in the
committed baseline ``src/repro_torch/analysis/baseline.json``).
``--json`` for machine output, ``--write-baseline`` to regenerate the
baseline, ``--artifact`` to also run the audit of the captured step
graphs (``artifact.py``: tiny engines on ``--device``, ``cuda`` unless
``cpu`` is given; it raises without a card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.findings import write_baseline
from repro_torch.analysis.runner import ALL_RULES, REPO_ROOT, run_paths

DEFAULT_BASELINE = os.path.join(REPO_ROOT, "src", "repro_torch", "analysis",
                                "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis "
                    "(rules: %s)" % ", ".join(ALL_RULES))
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: src/repro_torch)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: src/repro_torch/analysis/"
                         "baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from this run and exit 0")
    ap.add_argument("--artifact", action="store_true",
                    help="also audit the step graphs of tiny engines "
                         "(graph counts; on a card, each graph's nodes)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of --artifact's engines (default cuda)")
    args = ap.parse_args(argv)

    paths = args.paths or [os.path.join(REPO_ROOT, "src", "repro_torch")]
    rules = args.rules.split(",") if args.rules else None

    if args.write_baseline:
        findings = run_paths(paths, rules=rules, baseline=None)
        fps = write_baseline(args.baseline, findings)
        print(f"wrote {len(fps)} fingerprints to {args.baseline}")
        return 0

    baseline = None if args.no_baseline else args.baseline
    findings = run_paths(paths, rules=rules, baseline=baseline)

    if args.artifact:
        from repro_torch.analysis.artifact import audit_artifacts, render
        report = {}
        findings.extend(audit_artifacts(device=args.device, report=report))
        if not args.json:
            print(render(report))

    blocking = [f for f in findings if f.blocking]
    per_rule = {rule: sum(1 for f in findings if f.rule == rule)
                for rule in ALL_RULES}
    if args.json:
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "blocking": len(blocking),
                          "per_rule": per_rule}, indent=1))
    else:
        for f in findings:
            print(f.render())
        n_sup = sum(1 for f in findings if f.suppressed)
        n_base = sum(1 for f in findings if f.baselined)
        print("-- per rule: " + ", ".join(
            f"{rule}={n}" for rule, n in per_rule.items()))
        print(f"-- {len(findings)} findings: {len(blocking)} blocking, "
              f"{n_sup} allowed inline, {n_base} baselined")
    return 1 if blocking else 0


if __name__ == "__main__":
    sys.exit(main())
