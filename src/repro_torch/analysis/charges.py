"""Checker 3 — the charge auditor: no unpriced resource mutations, and
one config source for mirrored knobs.

The paper's core move is giving inference a DBMS-style resource cost
model: every KV movement (swap-out/in, demotion, promotion, reclaim)
carries a virtual-time charge or a stats update, and PR 5 established
that the engine and the simulator shadow read ONE source for the
policy/demotion knobs so their charges agree batch-for-batch.  Both
contracts were enforced by hand.  This checker audits them statically:

* ``unpriced-mutation`` — in ``serving/`` + ``core/``, every call to a
  state-mutating method of ``PagedAllocator`` / ``KVSwapStore`` (and
  the ``attach_prefix_run`` helper) must be *paired* with a charge or
  accounting update in the same function: a ``swap_time`` /
  ``batch_time`` pricing call, a virtual-clock advance (``now``,
  ``swap_s``, ``_tier_swap_s``), or a stats/bookkeeping touch
  (``stats[...]`` / ``swap_stats[...]`` / ``version`` / ``_nbytes`` /
  ``num_swaps`` / ``record_*``).  Pairing is control-flow aware: a
  charge sitting in a SIBLING branch arm of the mutation does not
  count (it can never execute on the mutation's path); a charge on the
  same straight-line path — before, after, or in a conditional the
  mutation dominates — does.  Mutations that are deliberately free
  (releasing pages costs nothing; the re-admission pays) carry an
  ``# repro: allow-unpriced-mutation(<reason>)``.

* ``config-mirror`` — every field name shared by ``SchedulerConfig``
  and ``EngineConfig`` is a mirrored knob and must be written through
  in ``Engine.__init__`` (``scheduler.cfg.<field> = ...``), the "one
  source" rule: a knob added to both configs but not threaded lets the
  engine's allocator and the simulator shadow silently disagree on
  which tier a prefix lands in.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.astutil import (ModuleIndex, dotted_name, last_attr,
                                    paths_compatible)
from repro_torch.analysis.findings import Finding

RULE = "unpriced-mutation"
RULE_MIRROR = "config-mirror"

SCOPES = ("serving/", "core/")

#: distinctive mutator method names — flagged on ANY receiver
MUTATORS_ANY_RECV = {
    "put_run", "put_prefix", "pop_runs", "pop_prefix", "register_prefix",
    "promote_prefix", "extend_shared", "ensure_private", "free_tail",
    "attach_prefix_run",
}
#: generic method names — flagged only on receivers that look like the
#: allocator / swap store (``self.allocator``, ``shadow.alloc``,
#: ``self.swap_store``, ``host_tier`` ...)
MUTATORS_STATE_RECV = {"allocate", "share", "free", "put", "pop"}
STATE_RECEIVERS = {"allocator", "alloc", "swap_store", "store",
                   "host_tier"}

#: what counts as a charge / accounting update
CHARGE_CALLS = {"swap_time", "_swap_time", "batch_time", "charge",
                "record_hit", "record_insert", "record_remove"}
CHARGE_NAMES = {"swap_s", "_tier_swap_s", "_carry_swap_s", "now",
                "num_swaps", "version", "_nbytes", "nbytes"}
CHARGE_SUBSCRIPTS = {"stats", "swap_stats", "prefix_stats"}


def in_scope(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(s in norm for s in SCOPES)


def _receiver(call: ast.Call) -> str:
    """Last attribute of the receiver chain ('' for bare calls):
    self.allocator.allocate(...) -> 'allocator'."""
    func = call.func
    if isinstance(func, ast.Attribute):
        recv = func.value
        name = dotted_name(recv)
        return last_attr(name)
    return ""


def _is_mutator(call: ast.Call) -> Optional[str]:
    name = dotted_name(call.func)
    bare = last_attr(name)
    if bare in MUTATORS_ANY_RECV:
        return bare
    if bare in MUTATORS_STATE_RECV and _receiver(call) in STATE_RECEIVERS:
        return bare
    return None


def _is_charge(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        return last_attr(dotted_name(node.func)) in CHARGE_CALLS
    if isinstance(node, (ast.AugAssign, ast.Assign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, (ast.Name, ast.Attribute)) \
                    and last_attr(dotted_name(t)) in CHARGE_NAMES:
                return True
            if isinstance(t, ast.Subscript) \
                    and last_attr(dotted_name(t.value)) \
                    in CHARGE_SUBSCRIPTS:
                return True
    return False


def check_module(mod: ModuleIndex) -> List[Finding]:
    out: List[Finding] = []
    if in_scope(mod.path):
        out.extend(_check_unpriced(mod))
    out.extend(_check_config_mirror(mod))
    return out


def _check_unpriced(mod: ModuleIndex) -> List[Finding]:
    out: List[Finding] = []
    for qual, info in sorted(mod.functions.items()):
        mutations = []
        charges = []
        for node in _own_body(info.node):
            if isinstance(node, ast.Call):
                m = _is_mutator(node)
                if m:
                    mutations.append((node, m))
            if _is_charge(node):
                charges.append(node)
        for node, method in mutations:
            mpath = mod.branch_path(node)
            if any(paths_compatible(mod.branch_path(c), mpath)
                   for c in charges):
                continue
            out.append(Finding(
                rule=RULE, path=mod.path, line=node.lineno,
                col=node.col_offset + 1, symbol=qual,
                message=f"`.{method}()` mutates allocator/swap-store "
                        f"state with no virtual-time charge or stats "
                        f"update on its control-flow path — unpriced "
                        f"resource traffic breaks the cost model's "
                        f"engine<->simulator parity"))
    return out


# --------------------------------------------------------------------- #
# config-mirror
# --------------------------------------------------------------------- #

def _dataclass_fields(cls: ast.ClassDef) -> Set[str]:
    return {stmt.target.id for stmt in cls.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)}


#: knobs whose mirroring is structural, not assignment-based (the
#: engine passes nslots as the scheduler's max_running, etc.)
_MIRROR_EXEMPT: Set[str] = set()


def _check_config_mirror(mod: ModuleIndex) -> List[Finding]:
    """Runs on the module that defines ``EngineConfig`` + ``Engine``;
    pulls ``SchedulerConfig`` from its import site lazily (the checker
    is handed one module at a time, so the scheduler fields are parsed
    from the sibling file)."""
    if "EngineConfig" not in mod.classes or "Engine" not in mod.classes:
        return []
    sched_fields = _sibling_scheduler_fields(mod)
    if not sched_fields:
        return []
    eng_fields = _dataclass_fields(mod.classes["EngineConfig"])
    shared = (eng_fields & sched_fields) - _MIRROR_EXEMPT
    if not shared:
        return []

    threaded: Set[str] = set()
    init = None
    for stmt in mod.classes["Engine"].body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name == "__init__":
            init = stmt
            break
    if init is not None:
        for node in ast.walk(init):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Attribute) \
                            and t.value.attr == "cfg":
                        threaded.add(t.attr)
    out = []
    for name in sorted(shared - threaded):
        out.append(Finding(
            rule=RULE_MIRROR, path=mod.path,
            line=mod.classes["EngineConfig"].lineno, col=1,
            symbol="EngineConfig",
            message=f"mirrored knob '{name}' exists in both "
                    f"EngineConfig and SchedulerConfig but is not "
                    f"written through in Engine.__init__ "
                    f"(scheduler.cfg.{name} = ...) — the engine "
                    f"allocator and the simulator shadow would read "
                    f"different sources"))
    return out


def _sibling_scheduler_fields(mod: ModuleIndex) -> Set[str]:
    import os
    base = os.path.dirname(os.path.dirname(mod.path))
    cand = os.path.join(base, "core", "scheduler.py")
    if not os.path.exists(cand):
        # findings carry repo-root-relative paths; resolve against the
        # repo root when the scan runs from elsewhere
        from repro_torch.analysis.runner import REPO_ROOT
        cand = os.path.join(REPO_ROOT, cand)
        if not os.path.exists(cand):
            return set()
    with open(cand) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "SchedulerConfig":
            return _dataclass_fields(node)
    return set()


def _own_body(fn_node: ast.AST):
    work = list(ast.iter_child_nodes(fn_node))
    while work:
        node = work.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        work.extend(ast.iter_child_nodes(node))
