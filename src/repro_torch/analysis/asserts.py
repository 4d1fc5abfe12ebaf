"""Checker 5 — bare ``assert`` statements guarding control-plane state.

The failure-model work (step transactions, fault injection) leans on
``check_invariants`` staying meaningful after every rollback — but a
plain ``assert`` disappears under ``python -O``, so an invariant
guarded by one is unenforced exactly when someone benchmarks with
optimizations on.  In the control plane (``serving/`` and ``core/``)
every assertion must therefore be one of:

* a real exception — ``ValueError`` for argument/config validation,
  ``repro_torch.core.invariants.invariant`` (an always-armed
  ``AssertionError`` subclass) for state invariants;
* an ``assert`` nested under an ``if ... check_invariants ...`` gate —
  those are explicitly opt-in debug validation, armed by config rather
  than by interpreter flags, and the gate documents the intent;
* annotated with ``# repro: allow-bare-invariant-assert(<reason>)``
  when a bare assert is genuinely the right tool (e.g. a
  type-narrowing hint).

Everything else is a finding.

The JAX package's module with its scope on the port's control plane
(``src/repro_torch/{serving,core}/``); JAX's rule scopes itself to
``src/repro/`` and never reads the port.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.astutil import ModuleIndex
from repro_torch.analysis.findings import Finding

RULE = "bare-invariant-assert"

#: the control plane the step-transaction machinery must trust
SCOPE = ("src/repro_torch/serving/", "src/repro_torch/core/")

_GATE_NAME = "check_invariants"


def in_scope(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(s in norm for s in SCOPE)


def _gated(mod: ModuleIndex, node: ast.AST) -> bool:
    """True when an ancestor ``if`` test mentions check_invariants."""
    cur = mod.parent(node)
    while cur is not None:
        if isinstance(cur, ast.If) and any(
                isinstance(n, (ast.Name, ast.Attribute))
                and getattr(n, "id", getattr(n, "attr", None)) == _GATE_NAME
                for n in ast.walk(cur.test)):
            return True
        cur = mod.parent(cur)
    return False


def check_module(mod: ModuleIndex) -> List[Finding]:
    if not in_scope(mod.path):
        return []
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Assert) or _gated(mod, node):
            continue
        out.append(Finding(
            rule=RULE, path=mod.path, line=node.lineno,
            col=node.col_offset + 1,
            symbol=mod.enclosing_function(node),
            message="bare `assert` vanishes under python -O: raise "
                    "ValueError (argument validation) or "
                    "`repro_torch.core.invariants.invariant` (state "
                    "invariant), or gate it under check_invariants"))
    return out
