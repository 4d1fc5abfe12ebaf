"""The traced run's device trace: ``torch.profiler`` over the last few
seconds of the window, reduced to device intervals, device time by kernel
name, and idle gaps labelled with what the host was doing.

The method is the one ``scripts/profile_port_serve.py`` uses (CPU + CUDA
activities over a steady window), read per interval so that idle time is
the window less the union of device intervals.  The window is bounded by
the harness's own ``portbench.*`` annotations, whose device echo is not
counted as device work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

ANNOTATION = "portbench."


@dataclass
class TraceData:
    window: Tuple[float, float]                 # seconds, trace clock
    device: List[Tuple[str, float, float]]      # (name, start, end)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self) -> List[Tuple[str, float, float]]:
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device
                if e > a and s < b]

    def busy_s(self) -> float:
        return sum(e - s for s, e in union(
            [(s, e) for _, s, e in self.clipped()]))

    def time_of(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(e - s for n, s, e in self.clipped()
                   if any(x in n for x in needles))

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.clipped():
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest spans with no device operation, each named
        by the innermost harness annotation around its middle and the
        host operation that overlaps it most."""
        a, b = self.window
        busy = union([(s, e) for _, s, e in self.clipped()])
        gaps, t = [], a
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        return [[self._label(s, e), e - s] for s, e in gaps[:k]]

    def _label(self, s: float, e: float) -> str:
        mid = (s + e) / 2
        ann = [h for h in self.host if h[0].startswith(ANNOTATION)
               and h[1] <= mid <= h[2]]
        where = min(ann, key=lambda h: h[2] - h[1])[0] if ann \
            else "outside the harness's steps"
        best, name = 0.0, None
        for n, hs, he in self.host:
            if n.startswith(ANNOTATION):
                continue
            ov = min(he, e) - max(hs, s)
            if ov > best:
                best, name = ov, n
        return f"{where}: {name}" if name else where


def union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """Start and stop ``torch.profiler`` around the sub-window; ``data``
    holds the reduced trace once stopped."""

    def __init__(self):
        self.prof = None
        self.data: Optional[TraceData] = None

    def _new(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """One empty profile during set-up: the profiler's first start is
        slow, and that cost belongs outside the window."""
        p = self._new()
        p.start()
        torch.zeros(1).add_(1)
        p.stop()

    def start(self) -> None:
        self.prof = self._new()
        self.prof.start()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def finish(self) -> Optional[TraceData]:
        """Reduce the stopped profile (after the window: parsing it takes
        seconds)."""
        if self.prof is not None:
            self.data = reduce_profile(self.prof)
            self.prof = None
        return self.data


def reduce_profile(prof) -> Optional[TraceData]:
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        span = (e.name, tr.start * 1e-6, tr.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(ANNOTATION):   # a range's device echo
                dev.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    ann = [h for h in host if h[0].startswith(ANNOTATION)]
    if not ann or not dev:          # no device trace: nothing to read
        return None
    window = (min(h[1] for h in ann), max(h[2] for h in ann))
    return TraceData(window=window, device=dev, host=host)
