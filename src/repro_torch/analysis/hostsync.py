"""Checker 2 — hidden host synchronizations in the port's serving hot path.

JAX's ``host-sync`` knows ``jax.device_get``, ``block_until_ready`` and
``np.asarray`` of device arrays; the port syncs in other words.  Every
device-to-host synchronization in the hot path (``serving/`` and
``core/kvcache.py``) is either a finding or carries an
``# repro: allow-host-sync(<reason>)`` rationale saying why blocking
there is the design (the per-step token fetch, the drain boundary).

Flagged (outside captured step functions: inside them ``graph-capture``
owns the diagnosis):

* ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` of a device
  tensor, and ``int()``/``float()``/``bool()`` over one;
* ``torch.cuda.synchronize()``, and ``Event.synchronize()`` /
  ``Stream.synchronize()`` outside the drain boundary (``HostLink.finish``
  and ``release``, which exist to wait);
* ``HostLink.fetch`` (the synchronous copy of ``async_swap=False``).

Device residency is a per-module taint (``flow``): a tensor made on the
host is no sync (``torch.tensor(x).item()``, ``host.numpy()``).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.astutil import ModuleIndex, dotted_name, last_attr
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.flow import SYNC_METHODS, Flow
from repro_torch.analysis.program import own_body, program_for

RULE = "host-sync"

#: files the rule applies to (the serving hot path)
HOT_PATHS = ("serving/", "core/kvcache.py")
#: the drain boundary: the HostLink methods whose job is to wait
DRAIN_BOUNDARY = ("finish", "release")
#: receivers of the host link's methods
LINK_RECEIVERS = {"_link", "link", "host_link"}


def in_scope(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(h in norm for h in HOT_PATHS)


def check_module(mod: ModuleIndex) -> List[Finding]:
    if not in_scope(mod.path):
        return []
    prog = program_for(mod)
    captured = {(q, ln) for (_, q, ln) in prog.captured_in(mod)}
    flow = Flow(prog, mod)
    out: List[Finding] = []
    for d in flow.defs:
        if (d.qual, d.node.lineno) in captured:
            continue                # graph-capture's domain
        for node in own_body(d.node):
            if not isinstance(node, ast.Call):
                continue
            msg = sync_message(flow, d, node)
            if not msg:
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "synchronize" \
                        and not dotted_name(f).endswith("cuda.synchronize") \
                        and d.name not in DRAIN_BOUNDARY:
                    msg = (f"`{dotted_name(f) or '.synchronize'}()` blocks "
                           f"the host outside the drain boundary "
                           f"(HostLink.finish / release)")
                elif isinstance(f, ast.Attribute) and f.attr == "fetch" \
                        and last_attr(dotted_name(f.value)) in LINK_RECEIVERS:
                    msg = ("`HostLink.fetch` is a synchronous device-to-host "
                           "copy in the hot path (start it on the copy "
                           "stream and drain it, or annotate)")
            if msg:
                out.append(Finding(rule=RULE, path=mod.path,
                                   line=node.lineno,
                                   col=node.col_offset + 1, symbol=d.qual,
                                   message=msg))
    return out


def sync_message(flow: Flow, d, node: ast.Call) -> str:
    """Why this call synchronizes the host with the device ('' if it
    does not): a host read of a device value, or a device-wide wait."""
    f = node.func
    name = dotted_name(f)
    if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS \
            and flow.dev(d, f.value):
        return (f"`.{f.attr}()` of a device tensor is a synchronous "
                f"device-to-host copy")
    if isinstance(f, ast.Name) and f.id in ("int", "float", "bool") \
            and node.args and flow.dev(d, node.args[0]):
        return (f"`{f.id}()` over a device tensor is a synchronous "
                f"device-to-host read")
    if name.endswith("cuda.synchronize"):
        return "`torch.cuda.synchronize()` stalls the host on the device"
    return ""
