"""Host transfers of the swap data plane: the port's counterpart of JAX's
``copy_to_host_async`` / ``jax.device_get`` / ``.at[].set`` trio.

A snapshot is first GATHERED on the compute stream into a fresh device
buffer (``gather_pages``: ``index_select`` over the pool's page axis;
``gather_slot``: one slot of every cache leaf).  The pools and the slot
state are written in place by the kernels, the decode append, the
copy-on-write copy and the slot merge, so a view (``pools[:, i]``) would
see the next step's writes; the gather is what lets the engine free the
source pages, or reuse the slot, in the same step.

``HostLink.start`` then copies the gathered buffers to pinned host
memory on the engine's own copy stream, which first waits on an event
recorded on the compute stream after the gather.  ``finish`` (the drain)
waits on the copy's done-event and returns numpy views of the pinned
buffers.  A bf16 buffer is handed over as its raw bits (an int16 view),
since numpy has no bf16; ``to_device`` views the bits back as the
target's dtype, never casting them, and copies them to the card on the
compute stream (``non_blocking``), where the engine's ``index_copy_``
follows in stream order.

Lifetimes across streams: a gathered buffer is marked as used by the
copy stream (``record_stream``) and held by its ``Transfer`` until the
drain, so the caching allocator cannot hand it to the next step while
the copy reads it.  A pinned source of a restore is held with an event
after its copy (``_held``) until that event has passed (``release``),
because the host allocator cannot see a copy made from a numpy view.

On a CPU device every step is synchronous and no stream or event exists:
that is the only difference, and it is keyed on the device type.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def nbytes_of(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_view(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a host tensor; bf16 as its raw bits (int16)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def gather_pages(k_pools: torch.Tensor, v_pools: torch.Tensor,
                 ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fresh device copies of the pools' pages ``ids``:
    ``{"k": (L, n, page, Hkv, D), "v": ...}``."""
    return {"k": k_pools.index_select(1, ids),
            "v": v_pools.index_select(1, ids)}


def restore_pages(k_pools: torch.Tensor, v_pools: torch.Tensor,
                  ids: torch.Tensor, kv: Dict[str, torch.Tensor]) -> None:
    k_pools.index_copy_(1, ids, kv["k"])
    v_pools.index_copy_(1, ids, kv["v"])


def _slot_axis(leaf: torch.Tensor) -> int:
    """Cache leaves are (L, nslots, ...) except the index (nslots,)."""
    return 0 if leaf.dim() == 1 else 1


def gather_slot(cache: Dict[str, torch.Tensor],
                slot: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fresh device copies of one slot of every cache leaf, the slot axis
    kept (size 1), as JAX's ``dynamic_slice_in_dim`` gives them.  A leaf
    sharded over a mesh (a DTensor) is gathered whole on every rank, so
    every rank holds and stores the one-rank engine's bytes."""
    from repro_torch.distributed.context import is_dtensor, spmd_scope
    with spmd_scope():
        out = {k: leaf.index_select(_slot_axis(leaf), slot)
               for k, leaf in cache.items()}
    return {k: v.full_tensor() if is_dtensor(v) else v
            for k, v in out.items()}


def restore_slot(cache: Dict[str, torch.Tensor], slot: torch.Tensor,
                 snap: Dict[str, torch.Tensor]) -> None:
    """Write whole slot rows ``snap`` (slot axis of size 1) into ``slot``
    of every leaf; a sharded leaf takes each rank's block of them."""
    from repro_torch.distributed.context import is_dtensor
    for k, leaf in cache.items():
        ax = _slot_axis(leaf)
        if not is_dtensor(leaf):
            leaf.index_copy_(ax, slot, snap[k])
            continue
        from repro_torch.serving.spmd import local_block, owned
        local, box = local_block(leaf)
        i = owned(box, ax, int(slot[0]))
        if i is not None:
            local[(slice(None),) * ax + (i,)] = \
                snap[k][box[:ax] + (0,) + box[ax + 1:]]


class Transfer:
    """One in-flight device-to-host copy: the pinned destination, the
    gathered source it holds alive, and (on a card) the events around the
    copy on the copy stream."""
    __slots__ = ("pinned", "src", "start", "done")

    def __init__(self, pinned, src, start, done):
        self.pinned: Dict[str, torch.Tensor] = pinned
        self.src: Optional[Dict[str, torch.Tensor]] = src
        self.start: Optional[torch.cuda.Event] = start
        self.done: Optional[torch.cuda.Event] = done

    @property
    def nbytes(self) -> int:
        return sum(nbytes_of(t) for t in self.pinned.values())

    def copy_ms(self) -> Optional[float]:
        """The copy's device time between its events (after ``finish``);
        None on the CPU."""
        return None if self.done is None else self.start.elapsed_time(
            self.done)


class HostLink:
    """The engine's host link: one copy stream (on a card) and the
    transfers in flight on it."""

    def __init__(self, device: Any):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.cuda else None)
        # (event after the copy, pinned source) of restores in flight
        self._held: List[Tuple[torch.cuda.Event, Any]] = []

    def ids(self, page_ids: Sequence[int]) -> torch.Tensor:
        """Page or slot ids as a device index (a non-blocking upload from
        pageable memory: staged at once, no device sync)."""
        return torch.from_numpy(np.asarray(page_ids, np.int64)).to(
            self.device, non_blocking=True)

    def start(self, leaves: Dict[str, torch.Tensor]) -> Transfer:
        """Start the device-to-host copy of freshly gathered ``leaves``."""
        if not self.cuda:
            return Transfer(leaves, None, None, None)
        gathered = torch.cuda.Event()
        gathered.record(torch.cuda.current_stream(self.device))
        pinned = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                  for k, v in leaves.items()}
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(gathered)
            start.record(self.stream)
            for k, v in leaves.items():
                v.record_stream(self.stream)
                pinned[k].copy_(v, non_blocking=True)
            done.record(self.stream)
        return Transfer(pinned, leaves, start, done)

    def finish(self, xfer: Transfer) -> Dict[str, np.ndarray]:
        """The drain: wait for the copy, then numpy views of its bytes."""
        if xfer.done is not None:
            xfer.done.synchronize()
        xfer.src = None
        return {k: _host_view(t) for k, t in xfer.pinned.items()}

    def fetch(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """The synchronous copy (``async_swap=False``): blocks the host
        until the bytes are there."""
        return {k: _host_view(v.cpu()) for k, v in leaves.items()}

    def to_device(self, x: Any, like: torch.Tensor) -> torch.Tensor:
        """A snapshot leaf as a tensor of ``like``'s dtype on its device.
        A leaf still on the device (a demotion promoted before its drain)
        is used as it is; host bytes are viewed back as ``like.dtype``
        and copied without blocking on the compute stream."""
        if isinstance(x, torch.Tensor):
            return x
        host = torch.from_numpy(x)
        if host.dtype != like.dtype:
            host = host.view(like.dtype)      # the raw bits, never a cast
        out = host.to(like.device, non_blocking=True)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._held.append((ev, x))
        return out

    def release(self, wait: bool = False) -> None:
        """Forget restore sources whose copies have finished (all of
        them, waiting, with ``wait``)."""
        if wait:
            for ev, _ in self._held:
                ev.synchronize()
            self._held.clear()
        else:
            self._held = [h for h in self._held if not h[0].query()]
