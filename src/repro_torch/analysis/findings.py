"""Findings, inline suppressions, and the committed baseline.

Every checker reports ``Finding``s.  A finding is *suppressed* by an
inline comment on the same line (or the line directly above):

    # repro: allow-<rule>(<rationale>)

The rationale is MANDATORY — an ``allow-`` marker without a non-empty
reason is itself reported (rule ``bad-suppression``): the point of the
allowlist is that every intentional violation documents WHY the cost
model tolerates it (which paper section / PR contract it trades
against), not just that someone silenced the tool.

Grandfathered findings live in a committed baseline file (JSON, one
line-number-insensitive fingerprint per finding) so the gate can be
green while old debt is paid down file-by-file; ``--write-baseline``
regenerates it and a meta-test asserts the committed file matches a
fresh run.

The JAX package's module with one difference: ``BASELINE_NOTE`` names
the port's command and README, since the port keeps its own baseline
(``src/repro_torch/analysis/baseline.json``).  The marker is the same,
so one inline allow in the port serves both analysers.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# allow-<rule>(<reason>)  |  allow-<rule>  (reason missing -> violation)
_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*allow-([a-z][a-z0-9-]*)\s*(?:\(([^)]*)\))?")


@dataclass
class Finding:
    rule: str                   # e.g. "host-sync", "recompile-hazard"
    path: str                   # repo-relative file path
    line: int                   # 1-based
    col: int
    message: str
    symbol: str = ""            # enclosing function/class qualname
    suppressed: bool = False
    reason: str = ""            # suppression rationale, when suppressed
    baselined: bool = False

    @property
    def fingerprint(self) -> str:
        """Line/column-insensitive identity — stable across unrelated
        edits so the baseline does not churn on every reflow."""
        return f"{self.rule}::{self.path}::{self.symbol}::{self.message}"

    @property
    def blocking(self) -> bool:
        return not (self.suppressed or self.baselined)

    def to_dict(self) -> Dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def render(self) -> str:
        tag = ""
        if self.suppressed:
            tag = f"  [allowed: {self.reason}]"
        elif self.baselined:
            tag = "  [baselined]"
        sym = f" ({self.symbol})" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}: "
                f"{self.message}{sym}{tag}")


@dataclass
class Suppression:
    rule: str
    line: int                   # line the comment sits on (1-based)
    reason: str
    used: bool = False


def parse_suppressions(source_lines: List[str], path: str
                       ) -> Tuple[Dict[int, List[Suppression]],
                                  List[Finding]]:
    """Scan a file's lines for ``# repro: allow-...`` markers.

    Returns (suppressions keyed by the line they APPLY to, malformed-
    suppression findings).  A marker applies to its own line and to the
    line below it (comment-above style), so both placements work.
    """
    by_line: Dict[int, List[Suppression]] = {}
    bad: List[Finding] = []
    for i, text in enumerate(source_lines, start=1):
        for m in _SUPPRESS_RE.finditer(text):
            rule, reason = m.group(1), (m.group(2) or "").strip()
            if not reason:
                bad.append(Finding(
                    rule="bad-suppression", path=path, line=i,
                    col=m.start() + 1,
                    message=f"allow-{rule} needs a rationale: "
                            f"# repro: allow-{rule}(<why the cost model "
                            f"tolerates this>)"))
                continue
            sup = Suppression(rule=rule, line=i, reason=reason)
            # applies to this line, and to the next (comment-above)
            by_line.setdefault(i, []).append(sup)
            by_line.setdefault(i + 1, []).append(sup)
    return by_line, bad


def apply_suppressions(findings: Iterable[Finding],
                       by_line: Dict[int, List[Suppression]]
                       ) -> List[Finding]:
    """Mark findings whose line carries a matching allow- marker."""
    out = []
    for f in findings:
        for sup in by_line.get(f.line, []):
            if sup.rule == f.rule:
                f.suppressed = True
                f.reason = sup.reason
                sup.used = True
                break
        out.append(f)
    return out


# --------------------------------------------------------------------- #
# baseline
# --------------------------------------------------------------------- #

BASELINE_NOTE = ("grandfathered findings; regenerate with "
                 "`python -m repro_torch.analysis --write-baseline` "
                 "(see src/repro_torch/analysis/README.md)")


def load_baseline(path: str) -> List[str]:
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return []
    return list(data.get("fingerprints", []))


def write_baseline(path: str, findings: Iterable[Finding]) -> List[str]:
    """Persist the fingerprints of all BLOCKING findings (suppressed
    ones stay suppressed in-source; baselining them too would hide a
    later edit that drops the annotation)."""
    fps = sorted({f.fingerprint for f in findings if f.blocking})
    with open(path, "w") as f:
        json.dump({"note": BASELINE_NOTE, "fingerprints": fps}, f, indent=1)
        f.write("\n")
    return fps


def apply_baseline(findings: Iterable[Finding],
                   fingerprints: Iterable[str]) -> List[Finding]:
    known = set(fingerprints)
    out = []
    for f in findings:
        if not f.suppressed and f.fingerprint in known:
            f.baselined = True
        out.append(f)
    return out
