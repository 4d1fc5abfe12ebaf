"""Checker 4 — the audit of the captured step graphs (``--artifact``): the
port's counterpart of JAX's compiled-artifact audit.

The source-level checkers see what the code says; this one looks at what
the engine built.  It runs a tiny engine per data plane (``batched``,
``paged``, ``legacy``) on JAX's audit workload
(``zipf_shared_prefix(n=10, num_groups=3, page_size=8, seed=3)``) and
audits its ``StepGraphs``:

* ``graph-budget`` — the counterpart of ``compile-budget``:
  ``Engine.num_graphs`` after the workload, held to the checked-in budget
  (``graph_budget.json``).  A key that leaks past the bucket ladder shows
  up as one more capture.  JAX's ``num_compiles`` also counts the
  engine's slot functions, so the two counts are not compared.
* ``artifact-graph`` — the counterpart of ``artifact-hlo``, on a card
  only: every built ``StepGraph``'s function is captured again over its
  static inputs into a ``torch.cuda.CUDAGraph(keep_graph=True)`` of the
  audit's own with ``enable_debug_mode()``, and the graph's
  ``debug_dump()`` (CUDA's DOT print) is read node by node.  A memcpy
  node to or from host memory, or a host node, is a finding: a host
  round trip inside a step.  The print names each memcpy's kind
  (``{kind | DtoD (DEVICE to DEVICE)}`` with CUDA 12.8, torch 2.11); a
  memcpy whose kind it does not name is a finding too, since the audit
  cannot clear it.  The hand-written kernels each graph launches (how
  far the kernels' launch counters, ``comm_analysis.custom_calls``, move
  during the capture; the moves are taken back out) are held to the
  budget file's list per plane.

The model is reduced ``tinyllama-1.1b`` in fp32 with its head dim raised
from 16 to 64, the least that B1 and B2 take on a card; the CPU and the
card build the same engines.  ``--device cpu`` audits the budget alone
(no graph is captured on the CPU).  After an intentional change, edit
``graph_budget.json`` to what a card run prints.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import tempfile
import time
from typing import Any, Dict, List, Optional

from repro_torch.analysis.findings import Finding

BUDGET_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "graph_budget.json")

RULE_BUDGET = "graph-budget"
RULE_GRAPH = "artifact-graph"

_MODEL = "tinyllama-1.1b"
PLANES = ("batched", "paged", "legacy")

#: CUDA graph node types as the DOT print names them
_NODE = re.compile(r"\b(KERNEL|MEMCPY|MEMSET|HOST|EMPTY|GRAPH|EVENT_RECORD|"
                   r"WAIT_EVENT|EVENT_WAIT|MEM_ALLOC|MEM_FREE|BATCH_MEM_OP|"
                   r"CONDITIONAL|EXT_SEMAS_SIGNAL|EXT_SEMAS_WAIT)\b")
#: a node statement starts its line (an edge's line starts with its tail)
_NODE_START = re.compile(r'^\s*"?(graph_\d+_node_\d+)"?\s*\[', re.M)
_HOST_KIND = re.compile(r"DtoH|HtoD|HtoH|DeviceToHost|HostToDevice|"
                        r"HostToHost|MemoryTypeHost|[Pp]inned|[Pp]ageable")
_DEVICE_KIND = re.compile(r"DtoD|DeviceToDevice|MemoryTypeDevice")


def audit_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(_MODEL).reduced(),
                               dtype="float32", head_dim=64)


def _tiny_engine(plane: str, device: str):
    from repro_torch.core import (TheoreticalCostModel, get_hardware,
                                  make_scheduler)
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig

    cfg = audit_config()
    params = M.init_params(cfg, seed=0, device=device)
    sched = make_scheduler("vllm", 256, S=512, replacement="srf")
    ekw = dict(nslots=4, cache_len=64, chunk=16, plane=plane)
    if plane == "paged":
        ekw.update(page_size=8, cache_policy="lru", cache_demotion=True)
    eng = Engine(cfg, params, sched, EngineConfig(**ekw),
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device=device)
    return cfg, eng


def run_tiny(plane: str, device: str):
    """The audit workload on a fresh tiny engine: (engine, seconds)."""
    from repro_torch.data.workloads import zipf_shared_prefix
    cfg, eng = _tiny_engine(plane, device)
    t0 = time.perf_counter()
    eng.run(zipf_shared_prefix(n=10, num_groups=3, page_size=8, seed=3,
                               vocab=cfg.vocab_size))
    return eng, time.perf_counter() - t0


def parse_dot(text: str) -> List[Dict[str, Any]]:
    """The nodes of a DOT print: [{"type", "text"}] in order."""
    starts = [m.start() for m in _NODE_START.finditer(text)]
    out = []
    for a, b in zip(starts, starts[1:] + [len(text)]):
        block = text[a:b]
        m = _NODE.search(block)
        out.append({"type": m.group(1) if m else "UNKNOWN", "text": block})
    return out


def memcpy_kind(block: str) -> str:
    """'host', 'device' or '' (the DOT text names no kind)."""
    if _HOST_KIND.search(block):
        return "host"
    return "device" if _DEVICE_KIND.search(block) else ""


def audit_graph(sg, dump_dir: str, tag: str) -> Dict[str, Any]:
    """Capture ``sg``'s function again with debug mode on and read its
    nodes (a card only)."""
    import torch
    from repro_torch.launch.comm_analysis import custom_calls
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    from repro_torch.serving.step_graphs import (add_counts, counts_moved,
                                                 kernel_counters, read_counts)
    counters = kernel_counters() + (flash_attention_cuda,)
    dev = sg.inputs[0].device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    # keep_graph: the cudaGraph_t survives the capture for debug_dump
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    calls0, counts0 = custom_calls(), read_counts(counters)
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with torch.no_grad(), torch.cuda.graph(graph, stream=side):
            sg.fn(*sg.inputs)
    finally:
        if collecting:
            gc.enable()
        calls1 = custom_calls()
        # a capture runs no kernel: take its counts back out
        add_counts(counters, counts_moved(counts0, read_counts(counters)),
                   sign=-1)
    main.wait_stream(side)
    kernels = {k: v - calls0.get(k, 0) for k, v in calls1.items()
               if v - calls0.get(k, 0)}
    path = os.path.join(dump_dir, f"{tag}.dot")
    graph.debug_dump(path)
    if not os.path.exists(path):
        raise RuntimeError(f"{tag}: CUDAGraph.debug_dump wrote no {path}")
    with open(path) as f:
        nodes = parse_dot(f.read())
    types: Dict[str, int] = {}
    for n in nodes:
        types[n["type"]] = types.get(n["type"], 0) + 1
    copies = [memcpy_kind(n["text"]) for n in nodes if n["type"] == "MEMCPY"]
    return {"shape": sg.shape, "nodes": dict(sorted(types.items())),
            "kernels": kernels, "host_memcpy": copies.count("host"),
            "unnamed_memcpy": copies.count(""),
            "host_nodes": types.get("HOST", 0)}


def audit_artifacts(device: str = "cuda", budget_path: str = BUDGET_PATH,
                    report: Optional[Dict[str, Any]] = None
                    ) -> List[Finding]:
    """Run the audit (see the module docstring).  ``report``, if given,
    takes each plane's graph count, seconds and, on a card, each graph's
    node counts, hand-written kernels and host copies."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--artifact needs a CUDA card (pass --device cpu "
                           "to audit the graph budget alone)")
    rel = os.path.relpath(budget_path, os.path.join(
        os.path.dirname(budget_path), "..", "..", ".."))
    with open(budget_path) as f:
        budget = json.load(f)
    caps = budget["num_graphs"]
    want_kernels = budget["kernels"]
    report = {} if report is None else report
    findings: List[Finding] = []
    with tempfile.TemporaryDirectory() as dump_dir:
        for plane in PLANES:
            eng, secs = run_tiny(plane, device)
            n = eng.num_graphs
            cap = caps.get(plane)
            entry: Dict[str, Any] = {"num_graphs": n, "budget": cap,
                                     "seconds": secs, "graphs": {}}
            report[plane] = entry
            if cap is None:
                findings.append(_f(rel, RULE_BUDGET, plane,
                                   f"no graph budget recorded for plane "
                                   f"'{plane}' (measured {n})"))
            elif n > cap:
                findings.append(_f(rel, RULE_BUDGET, plane,
                                   f"plane '{plane}' built {n} step graphs "
                                   f"on the audit workload, budget is {cap} "
                                   f"— a "
                                   f"graph key is leaking past the bucket "
                                   f"ladder"))
            if device != "cuda":
                continue
            used = set()
            for key, sg in eng.graphs.graphs.items():
                tag = f"{plane}-{str(key).replace('/', '_')}"
                g = audit_graph(sg, dump_dir, tag)
                entry["graphs"][str(key)] = g
                used.update(g["kernels"])
                if g["host_memcpy"] or g["host_nodes"] \
                        or g["unnamed_memcpy"]:
                    findings.append(_f(
                        rel, RULE_GRAPH, f"{plane}:{key}",
                        f"step graph '{key}' of plane '{plane}' holds "
                        f"{g['host_memcpy']} host memcpy node(s), "
                        f"{g['host_nodes']} host node(s) and "
                        f"{g['unnamed_memcpy']} memcpy node(s) of no named "
                        f"kind — a host round trip inside a captured step"))
            entry["kernels"] = sorted(used)
            want = sorted(want_kernels.get(plane, []))
            if sorted(used) != want:
                findings.append(_f(
                    rel, RULE_GRAPH, plane,
                    f"plane '{plane}' graphs launch the hand-written kernels "
                    f"{sorted(used)}, expected {want} (edit {rel} if "
                    f"intentional)"))
    return findings


def _f(rel: str, rule: str, symbol: str, message: str) -> Finding:
    return Finding(rule=rule, path=rel, line=1, col=1, symbol=symbol,
                   message=message)


def render(report: Dict[str, Any]) -> str:
    """One line per plane, then one per graph."""
    lines = []
    for plane, e in report.items():
        lines.append(f"{RULE_BUDGET} {plane}: {e['num_graphs']} step graphs "
                     f"(budget {e['budget']}) in {e['seconds']:.2f} s")
        for key, g in e["graphs"].items():
            kern = ", ".join(f"{k} x{v}" for k, v in sorted(
                g["kernels"].items())) or "none"
            lines.append(f"  {key} {g['shape']}: nodes {g['nodes']}; "
                         f"hand-written kernels {kern}; host memcpy "
                         f"{g['host_memcpy']}, host nodes {g['host_nodes']}")
    return "\n".join(lines)
