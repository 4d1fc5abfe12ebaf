"""Shared AST infrastructure for the repo-specific checkers.

One ``ModuleIndex`` per file: the parsed tree with

* every function (including nested ones and methods) indexed by
  qualname, with its parameters, the bare names it calls, and the
  function-valued names it passes as callbacks (``jax.lax.scan`` bodies
  and friends are traced, not called by name);
* the set of *jit roots* — functions handed to ``jax.jit`` / ``pmap`` /
  ``shard_map`` (as a call argument or decorator) — and the transitive
  *jit-reachable* closure over the local call graph, which is the scope
  of the recompile-hazard rules;
* the names jitted callables are BOUND to (``self._prefill_many =
  jax.jit(prefill_many)``), which is how call sites of compiled entry
  points are recognised;
* a *branch path* per AST node — the chain of (branch statement,
  branch arm) it sits under — so checkers can reason about control
  flow: two nodes are on *compatible* paths iff neither sits in a
  sibling arm of the other (then one always executes when the other
  does, modulo exceptions/loop trip counts).

Everything here is heuristic in the way any Python static analysis is:
names, not types.  The checkers are tuned to THIS repo's idioms and
verified against fixture corpora in ``tests/test_analysis.py``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

BranchPath = Tuple[Tuple[int, str], ...]

#: callables whose function-valued arguments run under the caller's
#: trace (so a jitted caller makes them jit-reachable)
_TRACING_CALLEES = {
    "scan", "while_loop", "fori_loop", "cond", "switch", "map",
    "tree_map", "custom_vjp", "custom_jvp", "checkpoint", "remat",
    "vmap", "grad", "value_and_grad",
}

_JIT_WRAPPERS = {"jit", "pmap", "shard_map"}


def dotted_name(node: ast.AST) -> str:
    """'jax.lax.scan' for Attribute chains, 'f' for Names, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if parts:                       # e.g. a call/subscript receiver
        return "." + ".".join(reversed(parts))
    return ""


def last_attr(name: str) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def free_names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def paths_compatible(a: BranchPath, b: BranchPath) -> bool:
    """True iff neither node lives in a sibling branch arm of the other
    (one path is a prefix of the other)."""
    n = min(len(a), len(b))
    return a[:n] == b[:n]


@dataclass
class FunctionInfo:
    qualname: str
    node: ast.AST                       # FunctionDef / AsyncFunctionDef
    params: List[str]
    calls: Set[str] = field(default_factory=set)       # dotted names
    callback_args: Set[str] = field(default_factory=set)
    parent: Optional[str] = None        # enclosing function qualname


class ModuleIndex:
    def __init__(self, path: str, source: str):
        self.path = path
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_bare_name: Dict[str, List[str]] = {}
        self.jit_roots: Set[str] = set()        # function qualnames
        self.jit_handles: Set[str] = set()      # bound names of jitted fns
        # functions whose body calls jax.lax.* / pallas_call: traced by
        # construction even when the jax.jit boundary lives in another
        # module (the engine jits paged_plane's builders' closures)
        self.trace_roots: Set[str] = set()
        self.classes: Dict[str, ast.ClassDef] = {}
        self._parents: Dict[int, ast.AST] = {}
        self._branch: Dict[int, BranchPath] = {}
        self._enclosing_fn: Dict[int, str] = {}
        self._index()

    # ------------------------------------------------------------------ #
    def branch_path(self, node: ast.AST) -> BranchPath:
        return self._branch.get(id(node), ())

    def enclosing_function(self, node: ast.AST) -> str:
        return self._enclosing_fn.get(id(node), "")

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def resolve(self, name: str) -> List[FunctionInfo]:
        """Functions matching a (possibly dotted) called name, by bare
        final name — the local-call-graph approximation."""
        return [self.functions[q]
                for q in self.by_bare_name.get(last_attr(name), [])]

    # ------------------------------------------------------------------ #
    def _index(self) -> None:
        # handles first: _walk consults them for callback collection
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and self._is_jit_wrapper(node.value):
                for t in node.targets:
                    handle = last_attr(dotted_name(t))
                    if handle:
                        self.jit_handles.add(handle)
        self._walk(self.tree, fn=None, path=())
        self._find_jit_bindings()

    def _walk(self, node: ast.AST, fn: Optional[str],
              path: BranchPath) -> None:
        for fieldname, value in ast.iter_fields(node):
            kids = value if isinstance(value, list) else [value]
            for kid in kids:
                if not isinstance(kid, ast.AST):
                    continue
                self._parents[id(kid)] = node
                kid_fn, kid_path = fn, path
                if isinstance(node, (ast.If, ast.Try, ast.For, ast.While,
                                     ast.ExceptHandler, ast.With)) \
                        and fieldname in ("body", "orelse", "handlers",
                                          "finalbody"):
                    kid_path = path + ((id(node), fieldname),)
                if isinstance(kid, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{fn}.{kid.name}" if fn else kid.name
                    info = FunctionInfo(
                        qualname=qual, node=kid,
                        params=[a.arg for a in (
                            kid.args.posonlyargs + kid.args.args
                            + kid.args.kwonlyargs)],
                        parent=fn)
                    self.functions[qual] = info
                    self.by_bare_name.setdefault(kid.name, []).append(qual)
                    for dec in kid.decorator_list:
                        if self._is_jit_wrapper(dec):
                            self.jit_roots.add(qual)
                    kid_fn, kid_path = qual, ()
                elif isinstance(kid, ast.ClassDef):
                    self.classes[kid.name] = kid
                elif isinstance(kid, ast.Call) and fn:
                    info = self.functions[fn]
                    name = dotted_name(kid.func)
                    if name:
                        info.calls.add(name)
                        if ".lax." in f".{name}" \
                                or last_attr(name) == "pallas_call":
                            self.trace_roots.add(fn)
                    if last_attr(name) in _TRACING_CALLEES \
                            or name in self.jit_handles:
                        for a in list(kid.args) + [k.value
                                                   for k in kid.keywords]:
                            if isinstance(a, ast.Name):
                                info.callback_args.add(a.id)
                self._branch[id(kid)] = kid_path
                if kid_fn:
                    self._enclosing_fn[id(kid)] = kid_fn
                self._walk(kid, kid_fn, kid_path)

    def _is_jit_wrapper(self, node: ast.AST) -> bool:
        """jax.jit / jit / pmap / shard_map, or partial(jax.jit, ...)."""
        name = dotted_name(node)
        if last_attr(name) in _JIT_WRAPPERS:
            return True
        if isinstance(node, ast.Call):
            if last_attr(dotted_name(node.func)) in _JIT_WRAPPERS:
                return True
            if last_attr(dotted_name(node.func)) == "partial" and node.args:
                return last_attr(dotted_name(node.args[0])) in _JIT_WRAPPERS
        return False

    def _find_jit_bindings(self) -> None:
        """jax.jit(f) calls: f becomes a root; an assignment target
        becomes a known compiled-entry-point handle.  Resolution is
        scope-aware: a local ``step`` closure handed to ``jax.jit``
        must not implicate an unrelated method that shares its bare
        name (``Engine.step``)."""
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and node.args \
                    and self._is_jit_wrapper(node):
                tgt = node.args[0]
                if isinstance(tgt, ast.Name):
                    cands = self.by_bare_name.get(tgt.id, [])
                    scope = self.enclosing_function(node)
                    local = [q for q in cands
                             if self.functions[q].parent == scope]
                    for q in (local or cands):
                        self.jit_roots.add(q)

    # ------------------------------------------------------------------ #
    def jit_reachable(self) -> Set[str]:
        """Qualnames of functions reachable from any jit boundary over
        the local call graph (callbacks included)."""
        seen: Set[str] = set()
        work = list(self.jit_roots | self.trace_roots)
        while work:
            q = work.pop()
            if q in seen or q not in self.functions:
                continue
            seen.add(q)
            info = self.functions[q]
            for name in list(info.calls) + list(info.callback_args):
                cands = self.resolve(name)
                local = [t for t in cands if t.parent == q]
                for target in (local or cands):
                    if target.qualname not in seen:
                        work.append(target.qualname)
        return seen


def index_module(path: str) -> ModuleIndex:
    with open(path) as f:
        return ModuleIndex(path, f.read())
