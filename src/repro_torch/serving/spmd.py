"""The engine over a device mesh: the port's counterpart of the JAX
engine's steps under ``set_mesh``.

JAX runs every step of an engine on a mesh as one GSPMD program from one
controller.  PyTorch has no single controller, so the port runs the same
``Engine`` on every rank of the mesh: the same scheduler on the cost
model's virtual time, the same allocator, swap store and fault plan.  The
ranks' host decisions then agree by construction, given equal inputs:

* virtual time, the schedule and every byte count come from the
  requests and the configs, never from a clock;
* fault draws are seeded and keyed by content (``serving.faults``);
* every host snapshot is of FULL tensors on every rank
  (``host_copy.gather_slot`` gathers a sharded leaf's slot whole), so
  the swap store holds the same bytes and makes the same capacity
  decisions on every rank as on one;
* the one measured input of a decision, the step's wall that the
  straggler monitor reads, is agreed first: its max over the mesh
  (``agree``), which is what a GSPMD step's wall is.

Measured walls that only accumulate (``Engine.wall``, ``phase_stats``,
the ``wall_*`` swap stats, ``BatchLog.wall_s``) stay rank-local: no
decision reads them.

The data plane's tensors are plain tensors, equal on every rank, except:

* ``impl="seqsharded"`` on a slot plane: the cache's ``k``/``v`` leaves
  are DTensors placed as ``sharding.out_pspecs_decode`` places them (the
  sequence over ``model``, the slots over the data axes);
* ``moe_impl="ep"``: the experts' stacked weights are DTensors placed as
  ``sharding.param_pspecs`` places them (the experts over ``model``).

Activations stay plain tensors: the model functions hand back a plain
value wherever their input was plain (``models.model._mlp_or_moe``,
the seqsharded branches of ``models.attention``).  Writes into a sharded
leaf go to each rank's own block (``local_block``); a read of whole rows
gathers them (``full_value``, ``host_copy.gather_slot``).

``agree`` also carries the engine's guard against silent divergence:
under ``check_invariants`` every step's greedy tokens are reduced over
the mesh with the wall, and ranks that disagree raise, naming the step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.context import is_dtensor


def local_block(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[slice, ...]]:
    """(this rank's block of ``x``, the slices of the global tensor that
    block holds).  The block shares the DTensor's storage, so writing it
    writes the DTensor.  A plain tensor is its own block."""
    if not is_dtensor(x):
        return x, tuple(slice(None) for _ in range(x.dim()))
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return x.to_local(), tuple(slice(o, o + n) for o, n in zip(off, shape))


def full_value(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor on every rank (a gather
    where it is sharded); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _slot_axis(leaf: torch.Tensor) -> int:
    return 0 if leaf.dim() == 1 else 1


def owned(box: Tuple[slice, ...], axis: int, slot: int) -> Optional[int]:
    """``slot``'s index in a block whose slot axis spans ``box[axis]``,
    or None where the block does not hold it."""
    s = box[axis]
    lo = s.start or 0
    if s.stop is None:
        return slot
    return slot - lo if lo <= slot < s.stop else None


def zero_slot(cache: Dict[str, torch.Tensor], slot: int) -> None:
    """Zero one slot of every leaf, in place (each rank its own block)."""
    for leaf in cache.values():
        local, box = local_block(leaf)
        ax = _slot_axis(leaf)
        i = owned(box, ax, slot)
        if i is not None:
            local[(slice(None),) * ax + (i,)] = 0


def merge_rows(cache: Dict[str, torch.Tensor], active: torch.Tensor,
               new_cache: Dict[str, torch.Tensor]) -> None:
    """The slot plane's masked merge: the rows of ``active`` (nslots,)
    of every leaf of ``new_cache`` are written into ``cache``'s leaf IN
    PLACE, and the other slots keep their state bit for bit.  In place
    because the step graphs are captured against the leaves: a new tensor
    would live in the graphs' pool, overwritten by the next replay.  A sharded
    leaf takes its own block of the new value: of a DTensor placed like
    it (the seqsharded decode's), or sliced from a plain global value (a
    prefill round's)."""
    for k, new in new_cache.items():
        local, box = local_block(cache[k])
        if is_dtensor(new):
            leaf = cache[k]
            if tuple(new.placements) != tuple(leaf.placements):
                new = new.redistribute(leaf.device_mesh, leaf.placements)
            new = new.to_local()
        elif is_dtensor(cache[k]):
            new = new[box]
        act = active[box[_slot_axis(local)]]
        # leaves are (L, nslots, ...), the index (nslots,)
        shape = (-1,) if new.dim() == 1 else (1, -1) + (1,) * (new.dim() - 2)
        torch.where(act.reshape(shape), new, local, out=local)


# --------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------- #


def kv_spec(cfg, nslots: int, cache_len: int, mesh):
    """The slot cache's ``k``/``v`` spec: ``sharding.out_pspecs_decode``'s
    for a decode of ``nslots`` rows against ``cache_len`` positions."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import out_pspecs_decode
    shape = ShapeConfig("engine", cache_len, nslots, "decode")
    return out_pspecs_decode(cfg, shape, mesh)[1]["k"]


def place_cache(cache: Dict[str, torch.Tensor], spec, mesh
                ) -> Dict[str, torch.Tensor]:
    """The slot cache with its ``k``/``v`` leaves sharded under ``spec``
    (each rank keeps its block; no communication); the other leaves
    stay plain."""
    from repro_torch.distributed.context import to_dtensor
    return {k: to_dtensor(v, mesh, spec) if k in ("k", "v") else v
            for k, v in cache.items()}


def place_experts(cfg, params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``params`` with the routed experts' stacked weights sharded as
    ``sharding.param_pspecs`` places them; every other leaf stays
    plain."""
    from repro_torch.distributed.context import to_dtensor
    from repro_torch.distributed.sharding import _EXPERT, param_pspecs
    specs = param_pspecs(cfg, params)
    moe = params["layers"]["moe"]
    placed = {k: (to_dtensor(v, mesh, specs["layers"]["moe"][k])
                  if k in _EXPERT and v.dim() == 4 else v)
              for k, v in moe.items()}
    return {**params, "layers": {**params["layers"], "moe": placed}}


def check_split(n: int, what: str, mesh, entry) -> None:
    """Refuse a dimension of ``n`` that the mesh axes ``entry`` (a spec
    entry) cannot split evenly: DTensor, like JAX, splits a sharded
    dimension evenly."""
    names = entry if isinstance(entry, tuple) else (entry,)
    size = int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                        for a in names if a is not None]))
    if entry is None or n % size:
        raise ValueError(f"{what} {n} does not split over the mesh axes "
                         f"{names} ({size} ranks)")


# --------------------------------------------------------------------- #
# agreement across the mesh
# --------------------------------------------------------------------- #


def mesh_max(values: Sequence[float], mesh) -> np.ndarray:
    """The elementwise max of ``values`` over every rank of ``mesh``: one
    all-reduce per mesh axis of more than one rank, in float64 (exact for
    walls and for token ids).  On the host for ``gloo``, on the card for
    ``nccl``."""
    t = torch.tensor(list(values), dtype=torch.float64)
    for i, name in enumerate(mesh.mesh_dim_names):
        if mesh.size(i) == 1:
            continue
        group = mesh.get_group(name)
        if dist.get_backend(group) == "nccl":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.cpu().numpy()  # repro: allow-host-sync(the agreed values decide on the host - one small float64 read per step over a mesh, whose steps run eagerly)


class DivergenceError(RuntimeError):
    """Ranks of one mesh took different tokens in one step."""


def agree(mesh, step: int, wall_s: float,
          tokens: Optional[np.ndarray]) -> float:
    """The step's wall agreed over the mesh (its max), and, given the
    step's greedy ``tokens`` (one per slot, -1 where a slot emitted
    none), the check that every rank took the same: the max of
    ``[wall, tokens, -tokens]`` is reduced in one all-reduce per axis,
    and a token whose max is not minus the max of its negation differs
    between ranks."""
    toks = [] if tokens is None else [float(t) for t in tokens]
    out = mesh_max([wall_s] + toks + [-t for t in toks], mesh)
    if toks:
        n = len(toks)
        hi, lo = out[1:1 + n], -out[1 + n:]
        bad = np.nonzero(hi != lo)[0]
        if bad.size:
            raise DivergenceError(
                f"step {step}: the ranks took different tokens in slots "
                f"{bad.tolist()} (max {hi[bad].tolist()}, min "
                f"{lo[bad].tolist()})")
    return float(out[0])
