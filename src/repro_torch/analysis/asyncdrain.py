"""Checker 7 — the port's async swap protocol: starts register, reads
drain, results drain everything, drains stay out of the graphs.

The port's swap path overlaps device-to-host copies with compute through
the engine's host link (``serving/host_copy.py``): ``HostLink.start``
copies freshly gathered buffers to pinned memory on the copy stream and
returns a ``Transfer``, whose host bytes exist only after a drain
boundary (``_drain_swaps`` / ``_drain_runs`` / ``_drain_demotes`` call
``HostLink.finish``, land the entry, CRC-seal it).  Between start and
drain the transfer sits in an in-flight buffer (``_pending_swaps`` /
``_pending_runs`` / ``_pending_demotes``).  JAX's rule looks for
``copy_to_host_async()``; the obligations are the same:

* **every start is registered** — a ``HostLink.start`` call (``.start``
  on ``self._link``) must be paired, on a compatible control-flow path,
  with a store into a ``self._pending_*`` buffer: in the same function,
  or, for payload builders (``_gather_pages_device`` returns the
  transfer), at every call site;
* **payload reads are dominated by a drain** — popping an entry out of
  the swap store and consuming its payload (``.cache`` / ``.kv``, or the
  entry passed whole) requires an earlier, path-compatible ``_drain_*``
  call in the same function (metadata-only pops need none);
* **the final result drains the world** — the function that builds
  ``EngineResult(...)`` calls a zero-argument ``_drain_swaps()`` first;
* **drains stay out of the graphs** — no ``_drain_*`` call in a function
  that a CUDA graph captures (``program.Program.captured``, across
  modules): a replay would skip its host work.

All four share one rule (``async-drain``); intentional exceptions carry
``# repro: allow-async-drain(<why the protocol holds anyway>)``.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set, Tuple

from repro_torch.analysis.astutil import (ModuleIndex, dotted_name, last_attr,
                                          paths_compatible)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.hostsync import LINK_RECEIVERS
from repro_torch.analysis.program import own_body, program_for

RULE = "async-drain"

SCOPES = ("serving/", "core/")

#: payload-popping methods on store-like receivers
POP_METHODS = {"pop", "pop_runs", "pop_prefix"}
STORE_RECEIVERS = {"swap_store", "store", "host_tier"}
#: attributes whose access means the entry's PAYLOAD is consumed
PAYLOAD_ATTRS = {"cache", "kv"}


def in_scope(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(s in norm for s in SCOPES)


def check_module(mod: ModuleIndex) -> List[Finding]:
    if not in_scope(mod.path):
        return []
    out: List[Finding] = []
    out.extend(_check_start_registration(mod))
    out.extend(_check_pop_drained(mod))
    out.extend(_check_result_drained(mod))
    out.extend(_check_drain_off_graph(mod))
    return out


def _is_start(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
        and node.func.attr == "start" \
        and last_attr(dotted_name(node.func.value)) in LINK_RECEIVERS


def _pending_stores(fn_node: ast.AST) -> List[ast.AST]:
    out = []
    for node in own_body(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and last_attr(dotted_name(t.value)) \
                        .startswith("_pending"):
                    out.append(node)
    return out


def _is_drain_name(bare: str) -> bool:
    return bare.startswith("_drain") or bare == "drain"


def _drain_calls(fn_node: ast.AST) -> List[ast.Call]:
    return [node for node in own_body(fn_node)
            if isinstance(node, ast.Call)
            and _is_drain_name(last_attr(dotted_name(node.func)))]


def _call_sites(mod: ModuleIndex, callee: str
                ) -> List[Tuple[str, ast.Call]]:
    sites = []
    for qual, info in sorted(mod.functions.items()):
        if callee not in {last_attr(c) for c in info.calls}:
            continue
        for node in own_body(info.node):
            if isinstance(node, ast.Call) \
                    and last_attr(dotted_name(node.func)) == callee:
                sites.append((qual, node))
    return sites


def _check_start_registration(mod: ModuleIndex) -> List[Finding]:
    out: List[Finding] = []
    for qual, info in sorted(mod.functions.items()):
        starts = [n for n in own_body(info.node) if _is_start(n)]
        if not starts:
            continue
        stores = _pending_stores(info.node)
        unregistered = [s for s in starts
                        if not any(paths_compatible(mod.branch_path(st),
                                                    mod.branch_path(s))
                                   for st in stores)]
        if unregistered:
            out.extend(_check_caller_registration(mod, qual,
                                                  unregistered[0]))
    return out


def _check_caller_registration(mod: ModuleIndex, qual: str,
                               start: ast.Call) -> List[Finding]:
    bare = qual.rsplit(".", 1)[-1]
    sites = [(c, n) for c, n in _call_sites(mod, bare) if c != qual]
    if not sites:
        return [Finding(
            rule=RULE, path=mod.path, line=start.lineno,
            col=start.col_offset + 1, symbol=qual,
            message=f"HostLink.start in {bare} is never registered in a "
                    f"self._pending_* buffer (here or at any call site) — "
                    f"no drain boundary will ever finish this transfer")]
    out = []
    for caller, node in sites:
        cinfo = mod.functions.get(caller)
        if cinfo is None:
            continue
        npath = mod.branch_path(node)
        if any(paths_compatible(mod.branch_path(s), npath)
               for s in _pending_stores(cinfo.node)):
            continue
        out.append(Finding(
            rule=RULE, path=mod.path, line=node.lineno,
            col=node.col_offset + 1, symbol=caller,
            message=f"{bare}() starts a host-link copy but this call site "
                    f"never registers it in a self._pending_* buffer on its "
                    f"control-flow path — the transfer has no drain "
                    f"boundary"))
    return out


def _check_pop_drained(mod: ModuleIndex) -> List[Finding]:
    out: List[Finding] = []
    for qual, info in sorted(mod.functions.items()):
        drains = _drain_calls(info.node)
        for pop, consumer in _consumed_pops(mod, info.node):
            ppath = mod.branch_path(pop)
            if any(d.lineno < pop.lineno
                   and paths_compatible(mod.branch_path(d), ppath)
                   for d in drains):
                continue
            method = last_attr(dotted_name(pop.func))
            out.append(Finding(
                rule=RULE, path=mod.path, line=pop.lineno,
                col=pop.col_offset + 1, symbol=qual,
                message=f".{method}() hands out a swap entry whose payload "
                        f"is consumed ({consumer}) with no preceding "
                        f"_drain_* call on this path — an in-flight entry "
                        f"still holds gathered device buffers here"))
    return out


def _receiver(call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return last_attr(dotted_name(call.func.value))
    return ""


def _consumed_pops(mod: ModuleIndex, fn_node: ast.AST
                   ) -> List[Tuple[ast.Call, str]]:
    body = list(own_body(fn_node))
    pops: List[Tuple[ast.Call, str]] = []
    for node in body:
        if not (isinstance(node, ast.Call)
                and last_attr(dotted_name(node.func)) in POP_METHODS
                and _receiver(node) in STORE_RECEIVERS):
            continue
        parent = mod.parent(node)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
                and isinstance(parent.targets[0], ast.Name):
            use = _payload_use(body, parent.targets[0].id, node.lineno)
        elif isinstance(parent, ast.For) and parent.iter is node \
                and isinstance(parent.target, ast.Name):
            use = _payload_use(list(ast.walk(parent)), parent.target.id,
                               node.lineno)
        else:
            use = ""
        if use:
            pops.append((node, use))
    return pops


def _payload_use(nodes: Iterable[ast.AST], binding: str,
                 after_line: int) -> str:
    for node in nodes:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == binding \
                and node.attr in PAYLOAD_ATTRS \
                and node.lineno >= after_line:
            return f".{node.attr} read"
        if isinstance(node, ast.Call) and node.lineno >= after_line:
            for a in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(a, ast.Name) and a.id == binding:
                    return f"passed whole to " \
                           f"{last_attr(dotted_name(node.func))}()"
    return ""


def _check_result_drained(mod: ModuleIndex) -> List[Finding]:
    out: List[Finding] = []
    for qual, info in sorted(mod.functions.items()):
        for node in own_body(info.node):
            if not (isinstance(node, ast.Call)
                    and last_attr(dotted_name(node.func)) == "EngineResult"):
                continue
            npath = mod.branch_path(node)
            if any(not d.args and not d.keywords and d.lineno < node.lineno
                   and paths_compatible(mod.branch_path(d), npath)
                   for d in _drain_calls(info.node)):
                continue
            out.append(Finding(
                rule=RULE, path=mod.path, line=node.lineno,
                col=node.col_offset + 1, symbol=qual,
                message="EngineResult is built with no preceding "
                        "zero-argument _drain_swaps() on this path — "
                        "in-flight swap/demote/run transfers would leak "
                        "device buffers into the returned stats"))
    return out


def _check_drain_off_graph(mod: ModuleIndex) -> List[Finding]:
    prog = program_for(mod)
    m = prog.module_of(mod)
    captured = prog.captured_in(mod)
    if m is None or not captured:
        return []
    out: List[Finding] = []
    seen: Set[int] = set()
    for d in m.defs:
        if d.key not in captured:
            continue
        for node in _drain_calls(d.node):
            if id(node) in seen:
                continue
            seen.add(id(node))
            out.append(Finding(
                rule=RULE, path=mod.path, line=node.lineno,
                col=node.col_offset + 1, symbol=d.qual,
                message=f"drain call inside a function a CUDA graph "
                        f"captures ({d.qual}) — its host wait fails the "
                        f"capture, and a replay would skip it"))
    return out
