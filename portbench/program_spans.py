"""The program's own spans in a traced run: ``repro_torch.serving.spans``
ranges (``engine.step`` and the phases inside it), read from the host
events that ``trace.reduce_profile`` keeps beside the device intervals.

From them: host milliseconds a step in one span (``schedule_ms``), and,
for ``scripts/portbench_phases.py``, idle time by the innermost span
around each idle instant and the longest gaps named by harness range,
program spans and host operation.  The gaps are ``TraceData.idle_gaps``' own.  A
trace of a program without spans gives nothing (``None``, or no span in
a label).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from portbench.trace import ANNOTATION, TraceData

PREFIX = "engine."          # repro_torch.serving.spans.PREFIX
STEP = PREFIX + "step"
OUTSIDE = "outside engine.step"

Span = Tuple[str, float, float]


def program(trace: TraceData) -> List[Span]:
    """The program's spans whose middle lies in the sub-window, by start
    (an outer span before the spans it holds)."""
    a, b = trace.window
    return sorted((h for h in trace.host if h[0].startswith(PREFIX)
                   and a <= (h[1] + h[2]) / 2 <= b),
                  key=lambda h: (h[1], -h[2]))


def per_step_ms(trace: TraceData, name: str) -> Optional[float]:
    """Host ms in span ``name`` a step of the sub-window."""
    spans = program(trace)
    steps = sum(1 for n, _, _ in spans if n == STEP)
    if not steps:
        return None
    return 1e3 * sum(e - s for n, s, e in spans if n == name) / steps


class _Where(TraceData):
    """A trace whose idle gaps are labelled by where they lie."""

    def _label(self, s: float, e: float):
        return s, e


def gaps(trace: TraceData) -> List[Tuple[float, float]]:
    """Every idle gap of the sub-window, longest first, as
    ``TraceData.idle_gaps`` finds them."""
    where = _Where(trace.window, trace.device, trace.host)
    return [g for g, _ in where.idle_gaps(k=len(trace.device) + 1)]


def _around(spans: List[Span], starts: List[float], t: float) -> List[str]:
    """The program spans open at instant ``t``, innermost first (spans
    nest, and every one lies in an ``engine.step``)."""
    out = []
    i = bisect.bisect_right(starts, t)
    while i:
        i -= 1
        n, _, e = spans[i]
        if e >= t:
            out.append(n)
        if n == STEP:
            break
    return out


def idle_by_span(trace: TraceData) -> Dict[str, float]:
    """Idle seconds of the sub-window by the innermost program span
    around them (``OUTSIDE`` where the host is in none): each gap is cut
    at the spans' ends inside it."""
    spans = program(trace)
    starts = [h[1] for h in spans]
    bounds = sorted({t for _, s, e in spans for t in (s, e)})
    out: Dict[str, float] = {}
    for s, e in gaps(trace):
        cuts = [s] + bounds[bisect.bisect_right(bounds, s):
                            bisect.bisect_left(bounds, e)] + [e]
        for a, b in zip(cuts, cuts[1:]):
            around = _around(spans, starts, (a + b) / 2)
            name = around[0] if around else OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def gap_labels(trace: TraceData, k: int = 10) -> List[List]:
    """The ``k`` longest idle gaps, each named by the innermost harness
    range around its middle, then the program spans around it below
    ``engine.step`` (outermost first), then the host operation outside
    both that overlaps it most: ``portbench.engine_step > engine.decode
    > engine.replay: cudaGraphLaunch``."""
    spans = program(trace)
    starts = [h[1] for h in spans]
    out = []
    for s, e in gaps(trace)[:k]:
        mid = (s + e) / 2
        ann = [h for h in trace.host if h[0].startswith(ANNOTATION)
               and h[1] <= mid <= h[2]]
        where = [min(ann, key=lambda h: h[2] - h[1])[0]] if ann \
            else ["outside the harness's steps"]
        around = _around(spans, starts, mid)
        where += [n for n in reversed(around) if n != STEP] if around \
            else [OUTSIDE]
        best, op = 0.0, None
        for n, hs, he in trace.host:
            if n.startswith(ANNOTATION) or n.startswith(PREFIX):
                continue
            ov = min(he, e) - max(hs, s)
            if ov > best:
                best, op = ov, n
        label = " > ".join(where)
        out.append([f"{label}: {op}" if op else label, e - s])
    return out
