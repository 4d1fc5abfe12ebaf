"""Collective accounting of the port's dry run: the counterpart of
``repro.launch.hlo_analysis``.

JAX reads what a step communicates from its compiled, SPMD-partitioned
HLO text.  The port has no HLO: the dry run (``launch.dryrun``) runs one
step on meta DTensors under ``StepRecorder``, a dispatch mode beneath
DTensor that sees each rank-local op, and records every
``_c10d_functional`` collective with its result bytes and group size,
and the FLOPs of the local ops.

* ``collective_bytes(log)`` is ``hlo_analysis.collective_bytes`` over
  that log: the same ``CollectiveStats`` (``bytes_by_kind``,
  ``count_by_kind`` under JAX's HLO kind names, ``link_bytes`` with the
  same ring factors).  There is no while-loop trip count to recover: the
  port's layer loop is Python, so the log holds every layer's
  collectives.
* ``custom_calls()`` is ``hlo_analysis.custom_calls``: where JAX's Pallas
  kernels appear as custom calls, the port's hand-written kernels count
  their launches (each wrapper's ``launches``).
* ``host_transfer_ops()`` is ``hlo_analysis.host_transfer_ops``: the
  collectives staged through host memory (``context.HOST_STAGED``).

``convert_traffic_bytes`` and ``duplicate_op_fraction`` read XLA's CPU
lowering (its f32 converts of bf16 dot operands, its rematerialized
dots), which has no counterpart in PyTorch; they are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: ``_c10d_functional`` op -> JAX's HLO kind name
KINDS = {"all_gather_into_tensor": "all-gather",
         "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


#: ops that allocate without writing (DTensor also makes global-shape
#: meta tensors with them): no bytes moved
_UNWRITTEN = ("empty", "new_empty")


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    # bytes actually moved over links per device (ring algorithm factors)
    link_bytes: float = 0.0

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(args: Sequence[Any]) -> int:
    """The size of the group a functional collective names (its last
    string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class StepRecorder(TorchDispatchMode):
    """Records what one rank runs: every functional collective as a log
    entry ``{"kind", "op", "bytes", "group"}`` (result bytes, as JAX
    counts an HLO op's result), the FLOPs of the rank-local ops
    (``torch.utils.flop_counter``'s formulas) and the bytes they read and
    write (``op_bytes``: inputs and outputs of every op but views and
    allocations, an unfused count).  Ops on DTensors are
    passed on (``NotImplemented``) to DTensor, which runs their local
    ops beneath this mode; DTensor's shape propagation on fake tensors is
    not counted."""

    def __init__(self):
        super().__init__()
        self.log: List[Dict[str, Any]] = []
        self.flops = 0
        self.op_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) for a in args):
            return out
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in KINDS:
            self.log.append({"kind": KINDS[name], "op": name,
                             "bytes": _nbytes(out),
                             "group": _group_size(args)})
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not (func.is_view or name.startswith(_UNWRITTEN)):
            self.op_bytes += _nbytes(list(args)) + _nbytes(out)
        return out


def collective_bytes(log: Sequence[Dict[str, Any]]) -> CollectiveStats:
    """``hlo_analysis.collective_bytes`` over a ``StepRecorder`` log."""
    stats = CollectiveStats()
    for e in log:
        kind, b, g = e["kind"], float(e["bytes"]), int(e["group"])
        stats.bytes_by_kind[kind] = stats.bytes_by_kind.get(kind, 0.0) + b
        stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + 1
        # per-device link traffic (ring algorithms)
        if kind == "all-reduce":
            factor = 2.0 * (g - 1) / max(g, 1)
        elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
            factor = (g - 1) / max(g, 1)
        else:  # point-to-point
            factor = 1.0
        stats.link_bytes += b * factor
    return stats


def custom_calls() -> Dict[str, int]:
    """The hand-written kernels' launches so far, wrapper name -> count:
    what JAX's ``custom_calls`` counts of its Pallas kernels in a lowered
    module."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_cuda
    from repro_torch.serving.step_graphs import kernel_counters
    return {f.__name__: f.launches
            for f in kernel_counters() + (flash_attention_cuda,)}


def host_transfer_ops() -> Dict[str, int]:
    """Collectives staged through host memory so far, name -> count (a
    ``gloo`` group on CUDA tensors): the port's host round trips inside a
    step, which JAX's ``host_transfer_ops`` finds as send/recv/infeed in
    the HLO."""
    from repro_torch.distributed.context import HOST_STAGED
    return {k: v for k, v in HOST_STAGED.items() if v}
