"""The port's modules as one program: imports, calls across modules, and
the step functions that CUDA graphs capture with everything they reach.

JAX's analyser finds a traced computation inside one module: a
``jax.jit`` binding or a ``lax`` callback marks its roots.  The port's
counterpart of a jitted step is a function that ``StepGraphs.get``
captures into a CUDA graph, and its body lives in other modules
(``serving/paged_plane.py``, ``serving/serve_step.py``, ``models/``,
``kernels/*/ops.py``), reached through the port's own imports.
``Program`` indexes every module under the package root of a scanned
file (the directory named ``repro_torch`` in its path; a file outside
such a tree, or not on disk, is a program of its own) and resolves a
call by name:

* ``f(...)``: a closure of an enclosing function, a module-level
  function, an imported one, or a local bound to one of these or to a
  builder's result (the closures the builder returns);
* ``mod.f(...)`` through an imported module alias;
* ``self.f(...)``: a method of the module, or an attribute bound to a
  builder's result (``self._paged_prefill, self._paged_decode =
  build_paged_fns(...)``: the returned closures, by tuple position);
* ``Cls.apply(...)``: the class's ``forward`` (an ``autograd.Function``);
* a function passed as an argument of a reached call is reached too
  (``decode_and_advance(self._paged_decode, ...)``).

A capture root is the first element of the tuple that a ``build``
handed to ``<...>.graphs.get(key, build)`` returns.  Functions are
keyed by (qualified name, line): ``astutil.ModuleIndex`` keys them by
name alone, and the engine's graph builders define ``fn`` once per
plane in two arms of one ``if``.

Names, not types, as in ``astutil``: the resolution is tuned to this
package's idioms and checked against fixture trees in
``tests/test_torch_analysis.py``.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.astutil import ModuleIndex, dotted_name, last_attr

PACKAGE = "repro_torch"
#: a function: (module name, qualified name, line of its ``def``)
FnKey = Tuple[str, str, int]
#: how deep a value is chased through assignments and builders
_DEPTH = 4


@dataclass(eq=False)
class Def:
    """One ``def`` of a module."""
    module: str
    qual: str
    node: ast.AST
    parent: Optional["Def"]         # enclosing function
    cls: Optional[str]              # enclosing class (methods)
    assigns: Dict[str, List[Tuple[ast.AST, Optional[int]]]] = \
        field(default_factory=dict)  # local name -> (value, tuple index)

    @property
    def key(self) -> FnKey:
        return (self.module, self.qual, self.node.lineno)

    @property
    def name(self) -> str:
        return self.node.name


#: own_body's walks, by function node (the node is held with its walk)
_BODIES: Dict[int, Tuple[ast.AST, List[ast.AST]]] = {}


def own_body(fn_node: ast.AST) -> List[ast.AST]:
    """Every node of a function but those of its nested functions (one
    walk per node, kept: the checkers read each body many times)."""
    hit = _BODIES.get(id(fn_node))
    if hit is not None and hit[0] is fn_node:
        return hit[1]
    out: List[ast.AST] = []
    work = list(ast.iter_child_nodes(fn_node))
    while work:
        node = work.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        out.append(node)
        work.extend(ast.iter_child_nodes(node))
    _BODIES[id(fn_node)] = (fn_node, out)
    return out


def _targets(node: ast.AST) -> List[ast.AST]:
    if isinstance(node, ast.Assign):
        return list(node.targets)
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    return []


def bindings(node: ast.AST) -> Iterator[Tuple[ast.AST, ast.AST,
                                              Optional[int]]]:
    """(target, value, tuple index) of an assignment, element by element
    where a tuple is unpacked (the index is None for a whole value)."""
    value = getattr(node, "value", None)
    if value is None:
        return
    for t in _targets(node):
        if isinstance(t, (ast.Tuple, ast.List)):
            for i, el in enumerate(t.elts):
                if isinstance(value, (ast.Tuple, ast.List)) \
                        and len(value.elts) == len(t.elts):
                    yield el, value.elts[i], None
                else:
                    yield el, value, i
        else:
            yield t, value, None


def self_attr(node: ast.AST) -> str:
    """'x' for ``self.x``; '' otherwise."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id in ("self", "cls"):
        return node.attr
    return ""


class _Module:
    def __init__(self, name: str, index: ModuleIndex, is_pkg: bool):
        self.name = name
        self.index = index
        self.is_pkg = is_pkg
        self.defs: List[Def] = []
        self.by_name: Dict[str, List[Def]] = {}
        self.self_binds: Dict[str, List[Tuple[Def, ast.AST,
                                              Optional[int]]]] = {}
        self.imports: Dict[str, str] = {}
        self.globals: Dict[str, List[ast.AST]] = {}  # module-level values
        self._collect()

    def _collect(self) -> None:
        def walk(node, parent: Optional[Def], cls: Optional[str]):
            for kid in ast.iter_child_nodes(node):
                if isinstance(kid, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{parent.qual}.{kid.name}" if parent \
                        else kid.name
                    d = Def(self.name, qual, kid, parent,
                            cls if parent is None else None)
                    self.defs.append(d)
                    self.by_name.setdefault(kid.name, []).append(d)
                    walk(kid, d, None)
                elif isinstance(kid, ast.ClassDef):
                    walk(kid, parent, kid.name if parent is None else None)
                else:
                    walk(kid, parent, cls)
        walk(self.index.tree, None, None)
        for node in self.index.tree.body:
            for t, value, i in bindings(node):
                if isinstance(t, ast.Name) and i is None:
                    self.globals.setdefault(t.id, []).append(value)
        for d in self.defs:
            for node in own_body(d.node):
                for t, value, i in bindings(node):
                    if isinstance(t, ast.Name):
                        d.assigns.setdefault(t.id, []).append((value, i))
                    elif self_attr(t):
                        self.self_binds.setdefault(self_attr(t), []).append(
                            (d, value, i))
        pkg = self.name if self.is_pkg else self.name.rpartition(".")[0]
        for node in ast.walk(self.index.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        self.imports[top] = top
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = pkg.split(".")
                    parts = parts[:len(parts) - node.level + 1]
                    base = ".".join(parts + ([base] if base else []))
                for a in node.names:
                    self.imports[a.asname or a.name] = f"{base}.{a.name}"

    def toplevel(self, name: str) -> List[Def]:
        return [d for d in self.by_name.get(name, [])
                if d.parent is None and d.cls is None]

    def methods(self, name: str, cls: Optional[str] = None) -> List[Def]:
        ms = [d for d in self.by_name.get(name, [])
              if d.parent is None and d.cls is not None]
        same = [d for d in ms if d.cls == cls]
        return same or ms


def package_root(path: str) -> Optional[str]:
    """The ``repro_torch`` directory that holds ``path``, or None."""
    parts = os.path.abspath(path).split(os.sep)
    if PACKAGE not in parts[:-1]:
        return None
    i = len(parts) - 1 - parts[::-1].index(PACKAGE, 1)
    return os.sep.join(parts[:i + 1])


def on_disk(path: str) -> Optional[str]:
    """``path`` as it exists: as given, or under the repository root
    (findings carry root-relative paths)."""
    if os.path.exists(path):
        return os.path.abspath(path)
    from repro_torch.analysis.runner import REPO_ROOT
    cand = os.path.join(REPO_ROOT, path)
    return cand if os.path.exists(cand) else None


def _module_name(root: str, path: str) -> Tuple[str, bool]:
    rel = os.path.relpath(os.path.abspath(path), os.path.dirname(root))
    parts = rel[:-3].split(os.sep)
    if parts[-1] == "__init__":
        return ".".join(parts[:-1]), True
    return ".".join(parts), False


def _tree_files(root: str) -> List[str]:
    out = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__",
                                                      "build"))
        out.extend(os.path.join(dirpath, f) for f in sorted(files)
                   if f.endswith(".py"))
    return out


class Program:
    """The modules of one package tree (see the module docstring)."""

    def __init__(self, modules: Dict[str, _Module]):
        self.modules = modules
        self._captured: Optional[Dict[FnKey, FnKey]] = None
        self._roots: Optional[List[Tuple[Def, ast.Call]]] = None

    # ------------------------------------------------------------------ #
    def module_of(self, mod: ModuleIndex) -> Optional[_Module]:
        """The program's module for ``mod``: itself, or the program's
        index of the same file and source."""
        for m in self.modules.values():
            if m.index is mod:
                return m
        path = on_disk(mod.path)
        for m in self.modules.values():
            if path and on_disk(m.index.path) == path \
                    and m.index.source_lines == mod.source_lines:
                return m
        return None

    def _target(self, dotted: str, depth: int = 0
                ) -> Tuple[str, object]:
        """('module', _Module) | ('defs', [Def]) | ('class', (_Module,
        name)) | ('', None) for an imported dotted name."""
        if dotted in self.modules:
            return "module", self.modules[dotted]
        mod, _, attr = dotted.rpartition(".")
        m = self.modules.get(mod)
        if m is None or depth > 4:
            return "", None
        if m.toplevel(attr):
            return "defs", m.toplevel(attr)
        if attr in m.index.classes:
            return "class", (m, attr)
        if attr in m.imports:
            return self._target(m.imports[attr], depth + 1)
        return "", None

    def _name(self, m: _Module, scope: Optional[Def], name: str,
              depth: int) -> List[Def]:
        """Functions a bare name stands for inside ``scope``."""
        s = scope
        while s is not None:
            local = [d for d in m.by_name.get(name, []) if d.parent is s]
            if local:
                return local
            s = s.parent
        if m.toplevel(name):
            return m.toplevel(name)
        if name in m.imports:
            kind, what = self._target(m.imports[name])
            if kind == "defs":
                return list(what)
            if kind == "class":
                cm, cname = what
                return [d for d in cm.defs if d.cls == cname
                        and d.name == "__call__"]
            return []
        out: List[Def] = []
        s = scope
        while s is not None and depth < _DEPTH:
            for value, i in s.assigns.get(name, []):
                out += self.value_defs(m, s, value, i, depth + 1)
            s = s.parent
        if not out and depth < _DEPTH:
            for value in m.globals.get(name, []):
                out += self.value_defs(m, None, value, None, depth + 1)
        return out

    def _table(self, m: _Module, scope: Optional[Def], table: ast.AST,
               depth: int) -> List[Def]:
        """The functions a lookup table of functions holds
        (``moe_mod.DISPATCH[impl](...)``: the values of a module-level
        dict)."""
        owner, name = m, ""
        if isinstance(table, ast.Name):
            name = table.id
        elif isinstance(table, ast.Attribute) \
                and isinstance(table.value, ast.Name) \
                and table.value.id in m.imports:
            kind, what = self._target(m.imports[table.value.id])
            if kind != "module":
                return []
            owner, name = what, table.attr
        out: List[Def] = []
        for value in owner.globals.get(name, []):
            if isinstance(value, ast.Dict):
                for v in value.values:
                    out += self.value_defs(owner, None, v, None, depth + 1)
        return out

    def callee_defs(self, m: _Module, scope: Optional[Def],
                    func: ast.AST, depth: int = 0) -> List[Def]:
        """The functions a call's ``func`` expression may run."""
        if isinstance(func, ast.Name):
            return self._name(m, scope, func.id, depth)
        if isinstance(func, ast.Subscript):
            return self._table(m, scope, func.value, depth)
        if not isinstance(func, ast.Attribute):
            return []
        attr = func.attr
        sa = self_attr(func)
        if sa:
            cls = _class_of(scope)
            out = list(m.methods(sa, cls))
            if depth < _DEPTH:
                for d, value, i in m.self_binds.get(sa, []):
                    out += self.value_defs(m, d, value, i, depth + 1)
            return out
        recv = dotted_name(func.value)
        if recv and "." not in recv and recv in m.imports:
            kind, what = self._target(m.imports[recv])
            if kind == "module":
                target: _Module = what
                if target.toplevel(attr):
                    return target.toplevel(attr)
                if attr in target.imports:
                    k2, w2 = self._target(target.imports[attr])
                    return list(w2) if k2 == "defs" else []
                return []
            if kind == "class" and attr == "apply":
                cm, cname = what
                return [d for d in cm.defs if d.cls == cname
                        and d.name == "forward"]
            return []
        if recv and "." not in recv and attr == "apply" \
                and recv in m.index.classes:
            return [d for d in m.defs if d.cls == recv
                    and d.name == "forward"]
        return []

    def value_defs(self, m: _Module, scope: Optional[Def], value: ast.AST,
                   index: Optional[int] = None, depth: int = 0
                   ) -> List[Def]:
        """The functions a value may be: a function reference, either arm
        of a conditional, a ``partial`` of one, or the closures that a
        builder call returns (the ``index``-th of a returned tuple)."""
        if depth > _DEPTH:
            return []
        if isinstance(value, (ast.Name, ast.Attribute)):
            return self.callee_defs(m, scope, value, depth)
        if isinstance(value, ast.IfExp):
            return (self.value_defs(m, scope, value.body, index, depth + 1)
                    + self.value_defs(m, scope, value.orelse, index,
                                      depth + 1))
        if isinstance(value, ast.BoolOp):
            return [d for v in value.values
                    for d in self.value_defs(m, scope, v, index, depth + 1)]
        if not isinstance(value, ast.Call):
            return []
        if last_attr(dotted_name(value.func)) == "partial" and value.args:
            return self.value_defs(m, scope, value.args[0], None, depth + 1)
        out: List[Def] = []
        for builder in self.callee_defs(m, scope, value.func, depth + 1):
            bm = self.modules[builder.module]
            for node in own_body(builder.node):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                ret = node.value
                if isinstance(ret, ast.Tuple):
                    elts = ret.elts if index is None else \
                        ret.elts[index:index + 1]
                else:
                    elts = [ret]
                for el in elts:
                    if isinstance(el, (ast.Name, ast.Attribute, ast.IfExp)):
                        out += self.value_defs(bm, builder, el, None,
                                               depth + 1)
        return out

    # ------------------------------------------------------------------ #
    def graph_gets(self) -> List[Tuple[_Module, Def, ast.Call]]:
        """Every ``<...>.graphs.get(key, build)`` call, with its module
        and enclosing function."""
        out = []
        for m in self.modules.values():
            for d in m.defs:
                for node in own_body(d.node):
                    if is_graph_get(node):
                        out.append((m, d, node))
        return out

    def capture_roots(self) -> List[Def]:
        roots: List[Def] = []
        for m, d, call in self.graph_gets():
            for build in self.value_defs(m, d, call.args[1]):
                bm = self.modules[build.module]
                for node in own_body(build.node):
                    if isinstance(node, ast.Return) \
                            and isinstance(node.value, ast.Tuple) \
                            and node.value.elts:
                        roots += self.value_defs(bm, build,
                                                 node.value.elts[0])
        return roots

    def captured(self) -> Dict[FnKey, FnKey]:
        """Every function a captured step function reaches: key -> the
        root it was reached from."""
        if self._captured is not None:
            return self._captured
        seen: Dict[FnKey, FnKey] = {}
        work = [(r, r.key) for r in self.capture_roots()]
        while work:
            d, root = work.pop()
            if d.key in seen:
                continue
            seen[d.key] = root
            m = self.modules[d.module]
            for node in own_body(d.node):
                if not isinstance(node, ast.Call):
                    continue
                nxt = self.callee_defs(m, d, node.func)
                for a in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(a, (ast.Name, ast.Attribute)):
                        nxt += self.value_defs(m, d, a)
                work += [(t, root) for t in nxt if t.key not in seen]
        self._captured = seen
        return seen

    def captured_in(self, mod: ModuleIndex) -> Dict[FnKey, FnKey]:
        m = self.module_of(mod)
        if m is None:
            return {}
        return {k: r for k, r in self.captured().items() if k[0] == m.name}

    def defs_of(self, mod: ModuleIndex) -> List[Def]:
        m = self.module_of(mod)
        return [] if m is None else m.defs


def _class_of(scope: Optional[Def]) -> Optional[str]:
    while scope is not None and scope.parent is not None:
        scope = scope.parent
    return scope.cls if scope is not None else None


def is_graph_get(node: ast.AST) -> bool:
    """``<...>.graphs.get(key, build)``: a ``StepGraphs`` lookup."""
    return isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
        and node.func.attr == "get" and len(node.args) >= 2 \
        and last_attr(dotted_name(node.func.value)) == "graphs"


# --------------------------------------------------------------------- #
# one Program per package tree, parsed once per state of its files
# --------------------------------------------------------------------- #

_TREES: Dict[str, Tuple[Tuple, Dict[str, Tuple[ModuleIndex, bool, str]]]] \
    = {}


def _parsed_tree(root: str) -> Dict[str, Tuple[ModuleIndex, bool, str]]:
    files = _tree_files(root)
    sig = tuple((f, os.stat(f).st_mtime_ns, os.stat(f).st_size)
                for f in files)
    hit = _TREES.get(root)
    if hit is not None and hit[0] == sig:
        return hit[1]
    from repro_torch.analysis.runner import display_path
    parsed: Dict[str, Tuple[ModuleIndex, bool, str]] = {}
    for f in files:
        name, is_pkg = _module_name(root, f)
        try:
            with open(f) as fh:
                parsed[name] = (ModuleIndex(display_path(f), fh.read()),
                                is_pkg, f)
        except SyntaxError:
            continue
    _TREES[root] = (sig, parsed)
    return parsed


def parsed_index(path: str, source: str) -> Optional[ModuleIndex]:
    """The index a package tree already holds for ``path`` with this
    source (the runner then parses each file once)."""
    root = package_root(path)
    if root is None:
        return None
    hit = _parsed_tree(root).get(_module_name(root, path)[0])
    if hit is not None and hit[2] == os.path.abspath(path) \
            and "\n".join(hit[0].source_lines) == "\n".join(
                source.splitlines()):
        return hit[0]
    return None


_PROGRAMS: Dict[Tuple[str, int], Program] = {}


def program_for(mod: ModuleIndex) -> Program:
    """The program ``mod`` belongs to: its package tree on disk, with
    ``mod`` in place of its file; a module not on disk, or outside a
    ``repro_torch`` tree, is a program of its own."""
    path = on_disk(mod.path)
    root = package_root(path) if path else None
    if root is None:
        name = os.path.splitext(os.path.basename(mod.path))[0]
        return Program({name: _Module(name, mod, False)})
    parsed = _parsed_tree(root)
    own, own_pkg = _module_name(root, path)
    key = (root, id(parsed))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = Program({n: _Module(n, idx, p)
                        for n, (idx, p, _) in parsed.items()})
        _PROGRAMS.clear()
        _PROGRAMS[key] = prog
    cur = prog.modules.get(own)
    if cur is not None and cur.index.source_lines == mod.source_lines:
        return prog
    mods = dict(prog.modules)
    mods[own] = _Module(own, mod, own_pkg)
    return Program(mods)
