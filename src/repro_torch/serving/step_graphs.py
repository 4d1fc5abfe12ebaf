"""One CUDA graph per serving-step shape: the port's counterpart of the
JAX engine's jitted step builders (``repro.serving.engine._build_jits``).

The JAX engine never runs a serving step op by op: each plane step is one
``jax.jit`` program, and ``warmup()`` compiles every signature the run
loop can hit (one prefill per ladder bucket, plus the fused decode).  The
port's steps are eager PyTorch, about 1,600 kernels per dense decode
step, so the host's cost of launching them, not the card, sets the wall.
A ``StepGraph`` turns one such step into one launch:

* it owns a step function, the static input buffers of one shape that the
  function reads, and the function's outputs;
* on a CUDA device its first call runs the function once eagerly on the
  engine's side stream (that builds and loads the kernels, and picks the
  cuBLAS algorithms: nothing may compile or load inside a capture), then
  captures it into a ``torch.cuda.CUDAGraph``; that first call returns
  the eager outputs, and every later call is one ``replay()`` whose
  outputs are the captured ones, overwritten by each replay.  A step may
  name a cheaper ``warm`` function to run eagerly in its place, one that
  launches every kernel at every shape the step does (the first layer of
  a stack of identical layers) and whose writes the step repeats; the
  first call then ends with a replay, so it still runs the step once.
  ``prepare()`` captures ahead of use and runs no step: an engine's
  ``warmup`` over inputs that do nothing;
* on the CPU every call runs the same function eagerly over the same
  static buffers -- a dispatch by the tensors' device, as in
  ``kernels/*/ops.py``, so the CPU tests exercise all of the buffer
  plumbing;
* a capture or replay that fails raises ``StepGraphError`` naming the
  step and its shape: a CUDA engine never quietly runs a step eagerly.

All graphs of one ``StepGraphs`` (one engine) share one memory pool
(``torch.cuda.graph_pool_handle()``) and are captured in order, on one
side stream.  The pool is shared, so a graph's outputs are valid only
until the next replay of ANY graph of the set: the engine fetches what it
needs at once and carries state across steps only in buffers allocated
outside the pool (the static inputs, the KV pools, the cache leaves).
Captures run under ``torch.no_grad()`` (``ops.wkv6`` is an
``autograd.Function``), with Python's cyclic garbage collector held off:
an engine lives in reference cycles (its graphs' step functions close
over it), so a dead one is freed by that collector, and freeing its
graphs, events and buffers inside another engine's capture invalidates
the capture.  Each capture collects first, then runs with the collector
disabled (``collector_held``); an engine's ``warmup`` holds it once
across all its captures, and those inside collect nothing more.

Kernel launch counters.  A kernel wrapper counts its launches where it
launches (``launches``, and ``launches_by_variant`` where it has one);
under a graph its Python runs only at capture.  So a capture records how
far each counter moved and takes those moves back out (a capture runs no
kernel), and every replay adds them again: the counters keep meaning
"launches run on the card".
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from repro_torch.core.invariants import invariant

#: a counter holder's reading: (launches, launches_by_variant)
Counts = Tuple[int, Dict[str, int]]


class StepGraphError(RuntimeError):
    """A step's capture or replay failed (the message names the step and
    its shape)."""


def kernel_counters() -> Tuple[Any, ...]:
    """The kernel wrappers whose launch counters the serving steps move:
    B1 and B2 (the pooled plane), B4 (the slot plane) and the grouped MoE
    layer."""
    from repro_torch.kernels.moe_grouped.moe_grouped import moe_grouped_cuda
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_decode_cuda, paged_prefill_cuda)
    from repro_torch.kernels.rwkv_scan.rwkv_scan import wkv6_cuda
    return (paged_decode_cuda, paged_prefill_cuda, wkv6_cuda,
            moe_grouped_cuda)


def read_counts(counters: Sequence[Any]) -> Tuple[Counts, ...]:
    return tuple((c.launches, dict(getattr(c, "launches_by_variant", {})))
                 for c in counters)


def counts_moved(before: Sequence[Counts],
                 after: Sequence[Counts]) -> Tuple[Counts, ...]:
    """How far each counter moved from ``before`` to ``after``."""
    return tuple((n1 - n0, {k: v - v0.get(k, 0) for k, v in by1.items()})
                 for (n0, v0), (n1, by1) in zip(before, after))


def add_counts(counters: Sequence[Any], moved: Sequence[Counts],
               sign: int = 1) -> None:
    """Add (or, with ``sign=-1``, take back) ``moved`` to the counters."""
    for c, (n, by) in zip(counters, moved):
        c.launches += sign * n
        for k, v in by.items():
            c.launches_by_variant[k] += sign * v


@contextlib.contextmanager
def collector_held():
    """Python's cyclic collector run once, then held off until the block
    ends; nothing where it is off already (inside an outer hold)."""
    if not gc.isenabled():
        yield
        return
    gc.collect()          # free dead engines before, not during
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


class StepGraph:
    """One step function over static input buffers of one shape (see the
    module docstring).  ``fn(*inputs)`` returns the step's outputs;
    ``state()`` returns the tensors outside ``inputs`` that the function
    reads or writes in place (pools, block tables, cache leaves): a graph
    captured against them must only ever replay against the same objects,
    which every call checks.  ``warm(*inputs)``, where given, runs eagerly
    in the step's place before the capture (module docstring)."""

    def __init__(self, name: str, fn: Callable[..., Any],
                 inputs: Sequence[torch.Tensor], owner: "StepGraphs",
                 state: Callable[[], Sequence[torch.Tensor]] = tuple,
                 warm: Optional[Callable[..., Any]] = None):
        self.name = name
        self.fn = fn
        self.warm = warm
        self.inputs = tuple(inputs)
        self.owner = owner
        self.state = state
        self._bound = tuple(state())
        self.graph: Optional[Any] = None
        self.outputs: Any = None
        self._moved: Tuple[Counts, ...] = ()

    @property
    def shape(self) -> str:
        return " ".join(str(tuple(t.shape)) for t in self.inputs)

    def _captures(self) -> bool:
        """Whether calls replay a graph (a card, no mesh) or run eagerly."""
        now = tuple(self.state())
        invariant(len(now) == len(self._bound)
                  and all(a is b for a, b in zip(now, self._bound)),
                  f"{self.name}: the pools or cache leaves it was built "
                  "against were replaced")
        return not self.owner.eager and self.inputs[0].device.type == "cuda"

    def __call__(self) -> Any:
        if not self._captures():
            with torch.no_grad():
                self.owner.eager_calls += 1
                return self.fn(*self.inputs)
        if self.graph is None:
            eager = self._capture()
            if self.warm is None:
                return eager
            self._replay()                # the first call runs the step
            return self.outputs
        self._replay()
        self.owner.replays += 1
        return self.outputs

    def prepare(self) -> None:
        """Ready the graph ahead of its first use, over inputs that do
        nothing (zero lengths, no active row): on a card, capture it after
        its eager warm-up and run no step; elsewhere one eager call."""
        if not self._captures():
            self()
        elif self.graph is None:
            self._capture()

    def _replay(self) -> None:
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise StepGraphError(f"{self.name} {self.shape}: replay failed: "
                                 f"{e}") from e
        add_counts(self.owner.counters, self._moved)

    def _capture(self) -> Any:
        owner, dev = self.owner, self.inputs[0].device
        side = owner.side_stream(dev)
        main = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        side.wait_stream(main)
        with torch.no_grad():
            before = read_counts(owner.counters)
            with torch.cuda.stream(side):       # builds/loads the kernels
                eager = (self.warm or self.fn)(*self.inputs)
            owner.eager_calls += 1
            if self.warm is not None:     # set-up, not the step: uncounted
                add_counts(owner.counters, counts_moved(
                    before, read_counts(owner.counters)), sign=-1)
            before = read_counts(owner.counters)
            graph = torch.cuda.CUDAGraph()
            try:
                with collector_held(), torch.cuda.graph(
                        graph, pool=owner.pool(), stream=side):
                    outputs = self.fn(*self.inputs)
            except Exception as e:   # any failure inside the capture
                raise StepGraphError(f"{self.name} {self.shape}: capture "
                                     f"failed: {e}") from e
            finally:
                # a capture runs no kernel: take its counts back out
                self._moved = counts_moved(before,
                                           read_counts(owner.counters))
                add_counts(owner.counters, self._moved, sign=-1)
        main.wait_stream(side)
        self.graph, self.outputs = graph, outputs
        owner.capture_s += time.perf_counter() - t0
        return eager


class StepGraphs:
    """The step graphs of one engine, keyed by step kind and shape: one
    memory pool and one side stream for all of them (made at the first
    capture), and the counts a run reads (``len``: graphs built;
    ``replays``; ``eager_calls``: calls that ran the function eagerly,
    every CPU call and each graph's first call on a card;
    ``capture_s``: host seconds spent in first calls).  With ``eager``
    every call runs its function eagerly over the static buffers and no
    graph is built (``len`` is 0): the steps of an engine over a mesh,
    which call ``gloo`` collectives on the host, cannot be captured."""

    def __init__(self, counters: Optional[Sequence[Any]] = None, *,
                 eager: bool = False):
        self.counters = tuple(kernel_counters() if counters is None
                              else counters)
        # every call eager over the static buffers, nothing captured: an
        # engine over a mesh, whose steps call host collectives
        self.eager = eager
        self.graphs: Dict[Hashable, StepGraph] = {}
        self.replays = 0
        self.eager_calls = 0
        self.capture_s = 0.0
        self._pool = None
        self._stream = None

    def __len__(self) -> int:
        return 0 if self.eager else len(self.graphs)

    def get(self, key: Hashable,
            build: Callable[[], Tuple[Any, ...]]) -> StepGraph:
        """The graph of ``key``, built on first use from ``build()`` ->
        (fn, static inputs, state) or (fn, static inputs, state, warm)."""
        g = self.graphs.get(key)
        if g is None:
            fn, inputs, state, *warm = build()
            g = self.graphs[key] = StepGraph(str(key), fn, inputs, self,
                                             state, *warm)
        return g

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def side_stream(self, device: torch.device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream
