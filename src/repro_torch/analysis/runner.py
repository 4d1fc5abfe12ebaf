"""Drives the checkers over a set of files and folds in suppressions
and the committed baseline: the JAX package's runner with the port's
rules (``ALL_RULES``)."""
from __future__ import annotations

import os
from typing import Iterable, List, Optional

from repro_torch.analysis import (asserts, asyncdrain, capture, charges,
                                  hostsync, ranklocal, statmirror, txncov)
from repro_torch.analysis.astutil import ModuleIndex
from repro_torch.analysis.findings import (Finding, apply_baseline,
                                           apply_suppressions, load_baseline,
                                           parse_suppressions)
from repro_torch.analysis.program import parsed_index

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

#: the rules of --artifact (``artifact.py``), which needs a card for the
#: second
ARTIFACT_RULES = ("graph-budget", "artifact-graph")

ALL_RULES = (
    capture.RULE, capture.RULE_SHAPE,
    hostsync.RULE,
    charges.RULE, charges.RULE_MIRROR,
    asserts.RULE,
    txncov.RULE, statmirror.RULE, asyncdrain.RULE,
    ranklocal.RULE,
    "bad-suppression",
) + ARTIFACT_RULES

_CHECKERS = (capture.check_module, hostsync.check_module,
             charges.check_module, asserts.check_module,
             txncov.check_module, statmirror.check_module,
             asyncdrain.check_module, ranklocal.check_module)


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git",
                                              "build"))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
    return sorted(set(out))


def display_path(path: str) -> str:
    """Repo-root-relative with forward slashes when under the repo —
    keeps finding fingerprints (and so the baseline) stable across
    invocation directories."""
    ap = os.path.abspath(path)
    if ap.startswith(REPO_ROOT + os.sep):
        return os.path.relpath(ap, REPO_ROOT).replace(os.sep, "/")
    return path.replace(os.sep, "/")


def check_file(path: str, rules: Optional[Iterable[str]] = None
               ) -> List[Finding]:
    shown = display_path(path)
    try:
        with open(path) as f:
            source = f.read()
        mod = parsed_index(path, source) or ModuleIndex(shown, source)
    except SyntaxError as e:
        return [Finding(rule="parse-error", path=shown,
                        line=e.lineno or 1, col=e.offset or 1,
                        message=str(e.msg))]
    findings: List[Finding] = []
    for checker in _CHECKERS:
        findings.extend(checker(mod))
    by_line, bad = parse_suppressions(mod.source_lines, shown)
    findings = apply_suppressions(findings, by_line)
    findings.extend(bad)
    if rules is not None:
        keep = set(rules)
        findings = [f for f in findings if f.rule in keep]
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def run_paths(paths: Iterable[str],
              rules: Optional[Iterable[str]] = None,
              baseline: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        findings.extend(check_file(path, rules=rules))
    if baseline:
        findings = apply_baseline(findings, load_baseline(baseline))
    return findings
