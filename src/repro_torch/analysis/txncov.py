"""Checker 5 — rollback completeness: every step-reachable mutation is
covered by a step-txn snapshot.

The batch loop is transactional: a mid-step fault rolls the
scheduler, allocator, swap store, every request, and the engine-local
view back to batch start (``serving/txn.py`` + ``Engine._begin_txn``).
The snapshot closures were hand-audited once; every new mutable
attribute added since is a silent hole — rollback "succeeds" and leaves
the new state poisoned.  This checker recomputes the write-sets
statically and cross-checks them against what the snapshots capture:

* **participant classes** (``PagedAllocator`` / ``KVSwapStore`` /
  ``Scheduler``) — when processing the module that DEFINES the class,
  its attribute write-set (self-attr stores, subscript stores/deletes,
  aug-assigns, container-mutator calls, in every method except
  ``__init__``) is compared against the attributes the matching
  ``txn.snapshot_*`` function reads off its participant parameter.
  A mutated-but-never-captured attribute is a finding at its first
  mutation site (so an intentional hole carries its allow right where
  the mutation lives).

* **``Request``** — the mutable-field surface (self-stores in
  ``Request`` methods, plus stores through request-typed receivers in
  the engine/scheduler/simulator, e.g. ``cand.predicted_output = ...``)
  is compared against ``txn._REQUEST_FIELDS`` + the container fields
  ``snapshot_requests`` copies explicitly.  Deleting one field from the
  snapshot list is exactly one finding.

* **the engine** — the attribute write-set of everything reachable
  from ``Engine.step()`` over the local call graph (the post-rollback
  ``repair`` closures included — they run by design on restored state)
  is compared against the first-level ``self.*`` attributes
  ``_begin_txn`` captures or hands to ``begin_step_txn``.  State that
  deliberately survives rollback (measured wall, recovery accounting,
  attempt bookkeeping) carries a rationale-bearing
  ``# repro: allow-txn-coverage(...)`` at its first mutation.

* **snapshot-bearing classes** (anything with a ``snapshot`` /
  ``snapshot_state`` method: ``PrefixTierSim``, ``_FaultMirror``,
  ``RadixPrefixRegistry``) — write-set of the other methods vs the
  attributes the snapshot reads plus the ones ``restore_state`` puts
  back (derived state may be captured on the restore side only).

Granularity is FIRST-LEVEL attributes: ``self.sched.num_swaps -= 1``
charges attr ``sched``, whose rollback is the scheduler snapshot's
job — each layer audits its own surface.

The JAX package's module with one difference: the files beside the
scanned one (``serving/txn.py``; the engine, scheduler and simulator
that store ``Request`` fields) resolve inside the scanned file's own
package tree (``_repo_file``), so the port's modules are audited
against the port's ``txn.py``.  JAX's rule resolves them through
``"src/repro/..."`` paths and reads JAX's files when it scans the port.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import ModuleIndex, dotted_name, last_attr
from repro_torch.analysis.findings import Finding

RULE = "txn-coverage"

SCOPES = ("serving/", "core/")

#: container-method calls that mutate their receiver
MUTATING_METHODS = {
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear", "sort", "appendleft",
}

#: participant class -> (txn snapshot function, human name)
PARTICIPANTS = {
    "PagedAllocator": "snapshot_allocator",
    "KVSwapStore": "snapshot_store",
    "Scheduler": "snapshot_scheduler",
}

#: local names the engine/scheduler/simulator bind Request objects to —
#: stores through these receivers count toward the Request write-set
REQUEST_RECEIVERS = {"r", "req", "v", "victim", "w", "winner", "cand"}

#: modules scanned for external Request-field stores (package-relative)
_REQUEST_MUTATOR_MODULES = (
    "serving/engine.py",
    "core/scheduler.py",
    "core/simulator.py",
)

_TXN_PATH = "serving/txn.py"


def in_scope(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(s in norm for s in SCOPES)


# --------------------------------------------------------------------- #
# write-set extraction
# --------------------------------------------------------------------- #

def _base_attr(node: ast.AST, recv: str) -> str:
    """First-level attribute of an access chain rooted at name ``recv``:
    ``self.sched.num_swaps`` -> 'sched', ``self._tables[rid].pages`` ->
    '_tables', ``other.x`` -> ''."""
    attr = ""
    while True:
        if isinstance(node, ast.Attribute):
            attr, node = node.attr, node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    if isinstance(node, ast.Name) and node.id == recv:
        return attr
    return ""


def _mutated_attrs(body: Iterable[ast.AST], recv: str
                   ) -> Dict[str, ast.AST]:
    """attr -> lexically-first mutation node, for stores / deletes /
    aug-assigns / mutating method calls rooted at ``recv``."""
    out: Dict[str, ast.AST] = {}

    def note(attr: str, node: ast.AST) -> None:
        if attr and (attr not in out
                     or node.lineno < out[attr].lineno):
            out[attr] = node

    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                               else [t]):
                        note(_base_attr(el, recv), node)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    note(_base_attr(t, recv), node)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATING_METHODS:
                note(_base_attr(node.func.value, recv), node)
    return out


def _class_methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {stmt.name: stmt for stmt in cls.body
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _class_write_set(cls: ast.ClassDef,
                     exclude: Tuple[str, ...] = ("__init__", "__post_init__")
                     ) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for name, fn in _class_methods(cls).items():
        if name in exclude or name.startswith("snapshot") \
                or name.startswith("restore"):
            continue
        for attr, node in _mutated_attrs(fn.body, "self").items():
            if attr not in out or node.lineno < out[attr].lineno:
                out[attr] = node
    return out


def _loaded_attrs(tree: ast.AST, recv: str) -> Set[str]:
    """First-level attributes READ off ``recv`` anywhere under ``tree``
    (a snapshot captures a field by loading it)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == recv:
            out.add(node.attr)
    return out


def _stored_attrs(tree: ast.AST, recv: str) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Store) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == recv:
            out.add(node.attr)
    return out


# --------------------------------------------------------------------- #
# sibling parsing (the checker is handed one module at a time)
# --------------------------------------------------------------------- #

def _repo_file(rel: str, near: str) -> Optional[str]:
    """Resolve a package-relative path (``serving/txn.py``) inside the
    ``repro_torch`` tree that holds the scanned file, falling back to the
    repository's own port (findings carry root-relative paths)."""
    from repro_torch.analysis.program import on_disk, package_root
    path = on_disk(near)
    root = package_root(path) if path else None
    if root is None:
        from repro_torch.analysis.runner import REPO_ROOT
        root = os.path.join(REPO_ROOT, "src", "repro_torch")
    cand = os.path.join(root, *rel.split("/"))
    return cand if os.path.exists(cand) else None


def _parse_sibling(rel: str, near: str) -> Optional[ast.Module]:
    path = _repo_file(rel, near)
    if path is None:
        return None
    try:
        with open(path) as f:
            return ast.parse(f.read())
    except (OSError, SyntaxError):
        return None


def _txn_function(tree: ast.Module, name: str
                  ) -> Optional[ast.FunctionDef]:
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _snapshot_captures(tree: ast.Module, fn_name: str) -> Set[str]:
    """Attributes a ``txn.snapshot_*`` function reads off its first
    (participant) parameter — the captured surface."""
    fn = _txn_function(tree, fn_name)
    if fn is None or not (fn.args.args or fn.args.posonlyargs):
        return set()
    param = (fn.args.posonlyargs + fn.args.args)[0].arg
    return _loaded_attrs(fn, param)


def _request_fields(tree: ast.Module) -> Set[str]:
    """``_REQUEST_FIELDS`` literals + the container fields
    ``snapshot_requests`` copies off the request loop variable."""
    fields: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "_REQUEST_FIELDS" \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    fields |= {e.value for e in node.value.elts
                               if isinstance(e, ast.Constant)
                               and isinstance(e.value, str)}
    fn = _txn_function(tree, "snapshot_requests")
    if fn is not None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "r":
                fields.add(node.attr)
    return fields


# --------------------------------------------------------------------- #
# checks
# --------------------------------------------------------------------- #

def check_module(mod: ModuleIndex) -> List[Finding]:
    if not in_scope(mod.path):
        return []
    out: List[Finding] = []
    out.extend(_check_participants(mod))
    out.extend(_check_request(mod))
    out.extend(_check_engine(mod))
    out.extend(_check_snapshot_classes(mod))
    return out


def _check_participants(mod: ModuleIndex) -> List[Finding]:
    """Modules defining a txn participant class: write-set vs what the
    sibling ``txn.snapshot_*`` captures."""
    hits = [(c, s) for c, s in PARTICIPANTS.items() if c in mod.classes]
    if not hits:
        return []
    txn_tree = _parse_sibling(_TXN_PATH, mod.path)
    if txn_tree is None:
        return []
    out: List[Finding] = []
    for clsname, snap_fn in hits:
        captured = _snapshot_captures(txn_tree, snap_fn)
        if not captured:        # snapshot gone entirely: other tests fail
            continue
        for attr, node in sorted(_class_write_set(
                mod.classes[clsname]).items()):
            if attr in captured:
                continue
            out.append(Finding(
                rule=RULE, path=mod.path, line=node.lineno,
                col=node.col_offset + 1, symbol=clsname,
                message=f"{clsname}.{attr} is mutated by step-reachable "
                        f"code but txn.{snap_fn} never captures it — "
                        f"a rolled-back step leaves it poisoned"))
    return out


def _check_request(mod: ModuleIndex) -> List[Finding]:
    """The module defining ``Request``: its mutable-field surface
    (internal self-stores plus request-receiver stores in the engine/
    scheduler/simulator) vs the ``snapshot_requests`` field list."""
    if "Request" not in mod.classes or "drop_suspended" not in \
            _class_methods(mod.classes["Request"]):
        return []                # the real state machine, not a stub
    txn_tree = _parse_sibling(_TXN_PATH, mod.path)
    if txn_tree is None:
        return []
    covered = _request_fields(txn_tree)
    if not covered:
        return []
    cls = mod.classes["Request"]
    internal = _class_write_set(cls)
    external: Dict[str, str] = {}
    for rel in _REQUEST_MUTATOR_MODULES:
        tree = _parse_sibling(rel, mod.path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Assign, ast.AugAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in REQUEST_RECEIVERS:
                    external.setdefault(
                        t.attr, f"src/repro_torch/{rel}:{node.lineno}")
    #: init-only or derived request attributes that no step mutates
    out: List[Finding] = []
    for field in sorted(set(internal) | set(external)):
        if field in covered:
            continue
        if field in internal:
            node = internal[field]
            line, col, where = node.lineno, node.col_offset + 1, \
                "Request methods"
        else:
            line, col = cls.lineno, 1
            where = external[field]
        out.append(Finding(
            rule=RULE, path=mod.path, line=line, col=col,
            symbol="Request",
            message=f"Request.{field} is mutated mid-step (via {where}) "
                    f"but txn.snapshot_requests never restores it — "
                    f"add it to _REQUEST_FIELDS or capture it "
                    f"explicitly"))
    return out


def _check_engine(mod: ModuleIndex) -> List[Finding]:
    """The module defining the engine: self-attr write-set of everything
    reachable from ``step`` vs what ``_begin_txn`` captures."""
    if "step" not in mod.functions or "_begin_txn" not in mod.functions:
        return []
    begin = mod.functions["_begin_txn"].node
    covered = _loaded_attrs(begin, "self")
    if not covered:
        return []

    # reachability closure from step over the local call graph
    reach: Set[str] = set()
    work = ["step"]
    while work:
        q = work.pop()
        if q in reach or q not in mod.functions:
            continue
        reach.add(q)
        for name in mod.functions[q].calls:
            for target in mod.resolve(name):
                if target.qualname not in reach:
                    work.append(target.qualname)
    reach.discard("_begin_txn")

    mutated: Dict[str, ast.AST] = {}
    for q in sorted(reach):
        fn = mod.functions[q].node
        body = fn.body if isinstance(
            fn, (ast.FunctionDef, ast.AsyncFunctionDef)) else [fn]
        for attr, node in _mutated_attrs_own(mod, body, "self").items():
            if attr not in mutated or node.lineno < mutated[attr].lineno:
                mutated[attr] = node

    out: List[Finding] = []
    for attr, node in sorted(mutated.items()):
        if attr in covered:
            continue
        out.append(Finding(
            rule=RULE, path=mod.path, line=node.lineno,
            col=node.col_offset + 1,
            symbol=mod.enclosing_function(node) or "step",
            message=f"self.{attr} is mutated on a path reachable from "
                    f"step() but _begin_txn neither captures it nor "
                    f"hands it to begin_step_txn — rollback leaves it "
                    f"poisoned"))
    return out


def _mutated_attrs_own(mod: ModuleIndex, body: Iterable[ast.AST],
                       recv: str) -> Dict[str, ast.AST]:
    """Like ``_mutated_attrs`` but skips nested function bodies — those
    are separate call-graph nodes (the engine's repair/restore closures
    are reached, or deliberately not, on their own)."""
    out: Dict[str, ast.AST] = {}
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        for attr, mnode in _shallow_mutations(node, recv):
            if attr and (attr not in out
                         or mnode.lineno < out[attr].lineno):
                out[attr] = mnode
        stack.extend(ast.iter_child_nodes(node))
    return out


def _shallow_mutations(node: ast.AST, recv: str
                       ) -> List[Tuple[str, ast.AST]]:
    hits: List[Tuple[str, ast.AST]] = []
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                hits.append((_base_attr(el, recv), node))
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            hits.append((_base_attr(t, recv), node))
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in MUTATING_METHODS:
        hits.append((_base_attr(node.func.value, recv), node))
    return hits


def _check_snapshot_classes(mod: ModuleIndex) -> List[Finding]:
    """Any class carrying its own ``snapshot``/``snapshot_state``:
    write-set of the other methods vs snapshot loads + restore stores."""
    out: List[Finding] = []
    for clsname, cls in sorted(mod.classes.items()):
        if clsname in PARTICIPANTS or clsname == "Request":
            continue            # audited against txn.py above
        methods = _class_methods(cls)
        snap = methods.get("snapshot") or methods.get("snapshot_state")
        if snap is None:
            continue
        captured = _loaded_attrs(snap, "self") \
            | _stored_attrs(snap, "self")
        restore = methods.get("restore_state") or methods.get("restore")
        if restore is not None:
            captured |= _stored_attrs(restore, "self")
        for attr, node in sorted(_class_write_set(cls).items()):
            if attr in captured:
                continue
            out.append(Finding(
                rule=RULE, path=mod.path, line=node.lineno,
                col=node.col_offset + 1, symbol=clsname,
                message=f"{clsname}.{attr} is mutated outside __init__ "
                        f"but {clsname}.{snap.name} never captures it — "
                        f"a rolled-back step leaves it poisoned"))
    return out
