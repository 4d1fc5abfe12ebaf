"""Checker 1 — hazards of the step functions that CUDA graphs capture: the
port's counterpart of JAX's ``recompile-hazard`` and ``dynamic-shape``.

The port keeps its serving steps shape-stable as CUDA graphs
(``serving/step_graphs.py``): a ``StepGraphs.get(key, build)`` builds a
step function over static input buffers, its first call captures it,
and every later call replays the capture.  A captured function has
failure modes of its own, none of which a CPU test sees (no CPU test
captures):

* ``graph-capture`` — inside a captured function (a root that a
  ``build`` returns, and everything it reaches across the port's modules,
  ``program.Program.captured``):

  - a host sync (``.item()``, ``.cpu()``, ``int()`` over a tensor,
    ``.synchronize()``): it fails the capture;
  - a tensor made from host data (``torch.tensor``/``as_tensor`` on a
    device, ``from_numpy``, ``.to(device)``/``.cuda()`` of a host value):
    its bytes are copied once, at capture, and frozen into the graph;
  - a Python ``if``/``while`` on tensor values: the branch taken at
    capture is frozen, with no warning (``.shape``, ``.dtype``,
    ``.device``, ``len`` and ``is None`` are static and fine);
  - a store through ``self`` (``self.k_pools = ...``,
    ``self.cache[k] = ...``, ``self.n += 1``): it runs once, at capture,
    and a graph replays against the buffers it was captured with;
  - any ``_drain_*`` or host-link call: host work that a replay skips.

  Outside captured functions: a read of a graph's outputs after another
  call into the same ``StepGraphs``.  All graphs of one engine share one
  memory pool, so a replay may overwrite any graph's outputs.

* ``graph-shape`` — a graph key (``self.graphs.get(key, ...)``) that does
  not derive from the bucket ladder (``self.buckets``,
  ``_bucket_for``), the row rungs (``self.rungs``, ``_rows_for``) or a
  constant, following the key's names to the call sites of its function.
  Each distinct key is one more capture, as each distinct shape is one
  more XLA compile in JAX.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.astutil import ModuleIndex, dotted_name, last_attr
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.flow import (Flow, cpu_literal, device_like,
                                       tensor_params)
from repro_torch.analysis.hostsync import LINK_RECEIVERS, sync_message
from repro_torch.analysis.program import (Def, Program, is_graph_get,
                                          own_body, program_for, self_attr)

RULE = "graph-capture"
RULE_SHAPE = "graph-shape"

#: how far a graph key is followed through call sites
_KEY_DEPTH = 4


def check_module(mod: ModuleIndex) -> List[Finding]:
    prog = program_for(mod)
    m = prog.module_of(mod)
    captured = prog.captured_in(mod)
    out: List[Finding] = []
    if m is None or not (captured or any(
            is_graph_get(n) for d in m.defs for n in own_body(d.node))):
        return out          # no captured function and no graph in sight
    keys = {(q, ln) for (_, q, ln) in captured}
    flow = Flow(prog, mod, keys)
    for d in flow.defs:
        root = captured.get(d.key)
        if root is not None:
            out.extend(_check_captured(flow, d, root))
        else:
            out.extend(_check_output_reads(flow, d))
    out.extend(_check_keys(prog, mod))
    return out


def _f(mod: ModuleIndex, node: ast.AST, d: Def, message: str,
       rule: str = RULE) -> Finding:
    return Finding(rule=rule, path=mod.path, line=node.lineno,
                   col=node.col_offset + 1, symbol=d.qual, message=message)


def _root_name(root) -> str:
    module, qual, _ = root
    return f"{module.rsplit('.', 1)[-1]}:{qual}"


def _self_rooted(node: ast.AST) -> bool:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if self_attr(node):
            return True
        node = node.value
    return False


def _check_captured(flow: Flow, d: Def, root) -> List[Finding]:
    mod = flow.mod
    where = f"in a function captured into a CUDA graph (from " \
            f"{_root_name(root)})"
    containers = {p for p, t in tensor_params(d.node).items() if not t}
    out: List[Finding] = []
    for node in own_body(d.node):
        if isinstance(node, ast.Call):
            f = node.func
            name = dotted_name(f)
            bare = last_attr(name)
            msg = sync_message(flow, d, node)
            if msg:
                out.append(_f(mod, node, d, f"{msg} {where}: it fails the "
                                            f"capture"))
            elif isinstance(f, ast.Attribute) and f.attr == "synchronize":
                out.append(_f(mod, node, d, f"`{name}()` {where}: a host "
                                            f"wait fails the capture"))
            elif bare.startswith("_drain") or bare == "drain" or (
                    isinstance(f, ast.Attribute)
                    and last_attr(dotted_name(f.value)) in LINK_RECEIVERS):
                out.append(_f(mod, node, d, f"host-link or drain call "
                                            f"`{name}()` {where}: host "
                                            f"work that a replay skips"))
            elif _host_data(flow, d, node):
                out.append(_f(mod, node, d, f"`{name}(...)` makes a device "
                                            f"tensor from host data {where}: "
                                            f"the bytes are frozen into the "
                                            f"graph at capture"))
        elif isinstance(node, (ast.If, ast.While)):
            if flow.dev(d, node.test) and not _truth_of(node.test,
                                                        containers):
                out.append(_f(mod, node, d, f"Python branch on a tensor "
                                            f"value {where}: the branch "
                                            f"taken at capture is frozen "
                                            f"(use torch.where; shape/dtype/"
                                            f"device branches are fine)"))
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                               ast.Delete)):
            targets = node.targets if isinstance(node, (ast.Assign,
                                                        ast.Delete)) \
                else [node.target]
            flat = [e for t in targets
                    for e in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                              else [t])]
            hit = [t for t in flat if _self_rooted(t)]
            if hit:
                t = hit[0]
                while isinstance(t, ast.Subscript):
                    t = t.value
                out.append(_f(mod, node, d, f"store to `{dotted_name(t)}"
                                            f"` {where}: it runs once, at "
                                            f"capture, and a replay reads "
                                            f"the buffers it was captured "
                                            f"against"))
    return out


def _truth_of(test: ast.AST, containers: Set[str]) -> bool:
    """The test only asks whether containers of tensors are empty."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _truth_of(test.operand, containers)
    if isinstance(test, ast.BoolOp):
        return all(_truth_of(v, containers) for v in test.values)
    if isinstance(test, ast.Subscript):       # layer_caches[0]
        return _truth_of(test.value, containers)
    return isinstance(test, ast.Name) and test.id in containers


def _host_data(flow: Flow, d: Def, call: ast.Call) -> bool:
    """A device tensor made from host data."""
    f = call.func
    name = dotted_name(f)
    bare, head = last_attr(name), name.split(".")[0]
    if bare == "from_numpy":
        return True
    if bare in ("tensor", "as_tensor") and head == "torch":
        return any(k.arg == "device" and not cpu_literal(k.value)
                   for k in call.keywords)
    if isinstance(f, ast.Attribute) and (
            f.attr == "cuda" or f.attr == "to" and any(
                device_like(a) for a in list(call.args)
                + [k.value for k in call.keywords])):
        return flow.host_made(d, f.value)
    return False


# --------------------------------------------------------------------- #
# outputs read after another replay
# --------------------------------------------------------------------- #

def _check_output_reads(flow: Flow, d: Def) -> List[Finding]:
    calls = sorted((n for n in own_body(d.node)
                    if isinstance(n, ast.Call) and flow.is_graph_call(d, n)),
                   key=lambda n: (n.lineno, n.col_offset))
    if len(calls) < 2:
        return []
    outputs: List[Tuple[str, ast.Call]] = []
    for node in own_body(d.node):
        if isinstance(node, ast.Assign) and node.value in calls:
            for t in node.targets:
                for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(el, ast.Name):
                        outputs.append((el.id, node.value))
    out: List[Finding] = []
    for name, made in outputs:
        later = [c for c in calls if c is not made
                 and (c.lineno, c.col_offset) > (made.lineno,
                                                 made.col_offset)]
        if not later:
            continue
        for node in own_body(d.node):
            if isinstance(node, ast.Name) and node.id == name \
                    and isinstance(node.ctx, ast.Load) \
                    and (node.lineno, node.col_offset) > (
                        later[0].lineno, later[0].col_offset):
                out.append(_f(flow.mod, node, d,
                              f"`{name}` holds a step graph's outputs and is "
                              f"read after another call into the same "
                              f"StepGraphs: the graphs share one memory "
                              f"pool, so that replay may have overwritten "
                              f"them (read or clone them first)"))
                break
    return out


# --------------------------------------------------------------------- #
# graph-shape: keys from the bucket ladder and the row rungs
# --------------------------------------------------------------------- #

def _ladder(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr in ("buckets", "rungs"):
            return True
        if isinstance(n, ast.Call) and last_attr(dotted_name(n.func)) \
                in ("_bucket_for", "_rows_for"):
            return True
    return False


def _check_keys(prog: Program, mod: ModuleIndex) -> List[Finding]:
    m = prog.module_of(mod)
    if m is None:
        return []
    out: List[Finding] = []
    for d in m.defs:
        for node in own_body(d.node):
            if not is_graph_get(node):
                continue
            bad = _underived(prog, m, d, node.args[0], 0)
            for site, where in bad:
                anchor = site if site is not None else node
                out.append(Finding(
                    rule=RULE_SHAPE, path=mod.path, line=anchor.lineno,
                    col=anchor.col_offset + 1,
                    symbol=where.qual if site is not None else d.qual,
                    message=f"graph key `{ast.unparse(node.args[0])}` of "
                            f"{d.qual} does not derive from the bucket "
                            f"ladder (self.buckets / _bucket_for), the row "
                            f"rungs (self.rungs / _rows_for) or a "
                            f"constant"
                            + (f" at this call site (`{ast.unparse(site)}`)"
                               if site is not None else "")
                            + ": every distinct key is one more CUDA graph "
                              "capture"))
    return out


def _underived(prog: Program, m, d: Def, expr: ast.AST, depth: int
               ) -> List[Tuple[Optional[ast.AST], Optional[Def]]]:
    """Where ``expr`` (inside ``d``) fails to derive from the ladder:
    [(call-site argument or None, its function)]; [] when it derives."""
    if isinstance(expr, ast.Constant) or _ladder(expr):
        return []
    if isinstance(expr, ast.JoinedStr):
        return [b for v in expr.values if isinstance(v, ast.FormattedValue)
                for b in _underived(prog, m, d, v.value, depth)]
    if isinstance(expr, (ast.Tuple, ast.List)):
        return [b for e in expr.elts
                for b in _underived(prog, m, d, e, depth)]
    if not isinstance(expr, ast.Name) or depth > _KEY_DEPTH:
        return [(None, None)]
    name = expr.id
    for node in own_body(d.node):                # loop / comprehension
        if isinstance(node, (ast.For, ast.comprehension)) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in ast.walk(node.target)):
            return _underived(prog, m, d, node.iter, depth + 1)
    if d.assigns.get(name):
        return [b for v, _ in d.assigns[name]
                for b in _underived(prog, m, d, v, depth + 1)]
    params = [a.arg for a in d.node.args.posonlyargs + d.node.args.args]
    if name not in params:
        return [(None, None)]
    pos = params.index(name)
    bad: List[Tuple[Optional[ast.AST], Optional[Def]]] = []
    sites = 0
    for caller in m.defs:
        for call in own_body(caller.node):
            if not isinstance(call, ast.Call) or d not in \
                    prog.callee_defs(m, caller, call.func):
                continue
            p = pos - (1 if params[0] in ("self", "cls")
                       and isinstance(call.func, ast.Attribute) else 0)
            arg = next((k.value for k in call.keywords if k.arg == name),
                       call.args[p] if 0 <= p < len(call.args) else None)
            if arg is None:
                continue
            sites += 1
            if _underived(prog, m, caller, arg, depth + 1):
                bad.append((arg, caller))
    return bad if sites else [(None, None)]
