"""Checker 9 — host decisions taken from rank-local values (no JAX
counterpart: the JAX engine is one program over a mesh, the port runs
one engine per rank).

Over a mesh (``serving/spmd.py``) every rank runs the same ``Engine``,
and the ranks stay in step only while each takes the same host
decisions: which requests to requeue, preempt or admit.  A value only
one rank sees -- its own wall clock, its rank -- must be agreed over the
mesh before a decision reads it, or one slow rank requeues while the
others decode and the ranks' collectives deadlock.  The engine's
straggler check is the case in point: ``Engine.step`` must not feed its
own ``time.perf_counter`` wall to ``StragglerMonitor.observe``;
``spmd.agree`` takes the max over the mesh first.

``rank-local`` (``serving/``) flags a decision fed by a rank-local
value:

* the decisions: an ``if``/``while`` test, and the arguments of
  ``StragglerMonitor.observe``, of a scheduler call (``self.sched.*``)
  and of a ``_requeue_*`` call;
* the rank-local values: ``time.perf_counter`` / ``time.time`` /
  ``time.monotonic``, ``dist.get_rank()``, any name assigned from one,
  and any ``self.`` attribute assigned from one anywhere in the module.

A name the function passes through ``spmd.agree`` or ``spmd.mesh_max``
is agreed and not flagged.  A wall only added into a stats dict decides
nothing (``self.swap_stats[...] += ...`` stores no attribute).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.astutil import ModuleIndex, dotted_name, last_attr
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.program import (Def, bindings, own_body,
                                          program_for, self_attr)

RULE = "rank-local"

SCOPES = ("serving/",)

#: calls whose value differs from rank to rank
SOURCES = {"perf_counter", "perf_counter_ns", "time", "time_ns",
           "monotonic", "monotonic_ns", "get_rank"}
#: calls that agree a value over the mesh
AGREE = {"agree", "mesh_max"}
SCHEDULER_RECEIVERS = {"sched", "scheduler"}


def in_scope(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(s in norm for s in SCOPES)


def _is_source(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    bare = last_attr(name)
    if bare not in SOURCES:
        return False
    if bare in ("time", "time_ns"):
        return name in ("time.time", "time.time_ns")
    return True


class _Taint:
    def __init__(self, defs: List[Def]):
        self.defs = defs
        self.attrs: Set[str] = set()
        self.local: Dict[int, Set[str]] = {}
        for _ in range(4):
            before = len(self.attrs)
            for d in defs:
                self.local[id(d)] = self._names(d)
            if len(self.attrs) == before:
                break

    def _names(self, d: Def) -> Set[str]:
        names: Set[str] = set()
        nodes = sorted((n for n in own_body(d.node)
                        if isinstance(n, (ast.Assign, ast.AugAssign,
                                          ast.AnnAssign))),
                       key=lambda n: (n.lineno, n.col_offset))
        for _ in range(2):
            for node in nodes:
                for t, value, _i in bindings(node):
                    if not self.tainted(value, names):
                        continue
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif self_attr(t):
                        self.attrs.add(self_attr(t))
        return names

    def tainted(self, e: ast.AST, names: Set[str]) -> List[str]:
        """The rank-local values ``e`` reads (names, attrs, calls)."""
        out = []
        for n in ast.walk(e):
            if isinstance(n, ast.Call) and _is_source(n):
                out.append(f"{dotted_name(n.func)}()")
            elif isinstance(n, ast.Name) and n.id in names \
                    and isinstance(n.ctx, ast.Load):
                out.append(n.id)
            elif self_attr(n) in self.attrs \
                    and isinstance(n.ctx, ast.Load):
                out.append(f"self.{n.attr}")
        return out


def check_module(mod: ModuleIndex) -> List[Finding]:
    if not in_scope(mod.path):
        return []
    prog = program_for(mod)
    m = prog.module_of(mod)
    if m is None:
        return []
    taint = _Taint(m.defs)
    out: List[Finding] = []
    for d in m.defs:
        names = set(taint.local[id(d)])
        agreed = _agreed(d)
        names -= agreed
        flagged: Set[int] = set()

        def hits(e: ast.AST) -> List[str]:
            return sorted(set(v for v in taint.tainted(e, names)
                              if v not in agreed
                              and v.replace("self.", "", 1) not in agreed))

        for node in own_body(d.node):
            if isinstance(node, (ast.If, ast.While)):
                vals = hits(node.test)
                if vals:
                    flagged.update(id(n) for n in ast.walk(node.test))
                    kind = type(node).__name__.lower()
                    out.append(_f(mod, node, d, f"`{kind}` test", vals))
        for node in own_body(d.node):
            if not isinstance(node, ast.Call) or id(node) in flagged:
                continue
            what = _decision_call(node)
            if not what:
                continue
            vals = [v for a in list(node.args)
                    + [k.value for k in node.keywords] for v in hits(a)]
            if vals:
                out.append(_f(mod, node, d, f"argument of `{what}`",
                              sorted(set(vals))))
    return out


def _decision_call(call: ast.Call) -> Optional[str]:
    f = call.func
    if not isinstance(f, ast.Attribute):
        bare = last_attr(dotted_name(f))
        return f"{bare}()" if bare.startswith("_requeue") else None
    recv = last_attr(dotted_name(f.value))
    if f.attr == "observe":
        return f"{dotted_name(f)}()"
    if recv in SCHEDULER_RECEIVERS:
        return f"{dotted_name(f)}()"
    if f.attr.startswith("_requeue"):
        return f"{dotted_name(f)}()"
    return None


def _agreed(d: Def) -> Set[str]:
    """Names and ``self`` attributes this function passes through
    ``spmd.agree`` / ``spmd.mesh_max``."""
    out: Set[str] = set()
    for node in own_body(d.node):
        if isinstance(node, ast.Call) \
                and last_attr(dotted_name(node.func)) in AGREE:
            for a in list(node.args) + [k.value for k in node.keywords]:
                for n in ast.walk(a):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
                    elif self_attr(n):
                        out.add(n.attr)
    return out


def _f(mod: ModuleIndex, node: ast.AST, d: Def, where: str,
       values: List[str]) -> Finding:
    return Finding(
        rule=RULE, path=mod.path, line=node.lineno, col=node.col_offset + 1,
        symbol=d.qual,
        message=f"{where} reads the rank-local {', '.join(values)}: over a "
                f"mesh each rank would decide on its own value (agree it "
                f"first: spmd.agree / spmd.mesh_max)")
