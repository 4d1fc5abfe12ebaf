"""Ambient mesh, partition specs and the collectives of the model's sharded
regions: ``repro.distributed.context`` on ``torch.distributed``.

Model code (sequence-sharded decode attention, expert-parallel MoE)
needs the mesh to build a sharded region; launchers set it with
``set_mesh`` and single-device callers leave it unset.

* ``PartitionSpec`` (``P``): JAX's spec, a tuple with one entry per
  tensor dimension: an axis name, a tuple of axis names (sharded over
  their product, the first one major) or ``None``.  ``placements``
  turns one into DTensor placements over a ``DeviceMesh``.
* ``shard_map_compat``: ``jax.shard_map``'s counterpart over
  ``torch.distributed.tensor.experimental.local_map``.  Inputs that are
  plain tensors are global values every rank holds; each rank keeps its
  slice (no communication).  DTensor inputs are redistributed to the
  input specs.  Outputs are DTensors under the output specs.
* ``pmax``, ``psum``, ``all_to_all``, ``axis_index``: the collectives of
  a region, over one mesh axis's process group; ``psum`` and
  ``all_to_all`` are differentiable.  Ranks that share one card use
  ``gloo`` over CUDA tensors, which runs these on the card; DTensor's
  all-gather it cannot run there goes through pinned host memory
  (``stage_cuda_all_gather``), and ``HOST_STAGED`` counts each such
  copy-out, gather and copy-back.
* ``spmd_scope``: the model functions run under it, so that the plain
  tensors they make (positions, masks, the optimizer's scalars) meet
  DTensors as replicated values.
"""
from __future__ import annotations

import contextlib
import functools
import math
from collections import Counter
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist

_MESH = None
_IN_SCOPE = False
_STAGED_GATHER = None

#: host-staged collectives by name, since the process started
HOST_STAGED: Counter = Counter()


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: ``P("data", None)``.  Entries are
    normalized as JAX normalizes them: a one-name tuple is the name, an
    empty tuple is ``None``."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            (d[0] if len(d) == 1 else d or None) if isinstance(d, tuple)
            else d for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def placements(mesh, spec: Sequence) -> list:
    """DTensor placements over ``mesh`` for a partition spec: mesh axis
    ``a`` shards tensor dimension ``d`` when ``spec[d]`` names it (alone
    or in a tuple), and replicates otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def to_dtensor(x: torch.Tensor, mesh, spec: Sequence):
    """``x`` on ``mesh`` under ``spec``: a DTensor is redistributed; a
    plain tensor is the global value, which every rank holds, and each
    rank keeps its own slice of it (no communication).  Differentiable:
    the plain tensor's gradient is the global one on every rank (the
    slices' gradients gathered), as JAX's is.  Sharded dimensions must
    divide evenly, as JAX requires."""
    from torch.distributed.tensor import DTensor, Replicate
    pl = placements(mesh, spec)
    if isinstance(x, DTensor):
        return x if list(x.placements) == pl else x.redistribute(mesh, pl)
    for i, p in enumerate(pl):
        if p.is_shard() and x.shape[p.dim] % mesh.size(i):
            raise ValueError(f"dimension {p.dim} of {tuple(x.shape)} does "
                             f"not split over {mesh.size(i)} ranks")
    whole = DTensor.from_local(x, mesh, [Replicate()] * len(pl),
                               run_check=False)
    return whole if all(p.is_replicate() for p in pl) else \
        whole.redistribute(mesh, pl)


def spec_of(x: torch.Tensor) -> P:
    """The partition spec of a DTensor's placements (a plain tensor's is
    all ``None``: the global value, on every rank)."""
    if not is_dtensor(x):
        return P(*([None] * x.ndim))
    dims = [() for _ in range(x.ndim)]
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            dims[p.dim] += (name,)
    return P(*dims)


def _grad_placements(mesh, spec, varying) -> list:
    """An input's gradient placements: its shards, and over an axis it
    is replicated on, a partial sum where the ranks of the axis see
    different data (another input is sharded over it), else replicated
    (every rank computed the same gradient)."""
    from torch.distributed.tensor import Partial
    return [p if p.is_shard() or name not in varying else Partial()
            for name, p in zip(mesh.mesh_dim_names, placements(mesh, spec))]


def shard_map_compat(f, *, mesh, in_specs, out_specs):
    """``jax.shard_map``: ``f`` runs on every rank on its local shards of
    the inputs (``in_specs``); its local outputs are assembled as
    DTensors under ``out_specs``.  The gradient of an input replicated
    over an axis over which another input is sharded is the sum of the
    ranks' local gradients (``_grad_placements``)."""
    from torch.distributed.tensor.experimental import local_map
    multi = isinstance(out_specs, tuple) and not isinstance(out_specs, P)
    outs = (tuple(placements(mesh, s) for s in out_specs) if multi
            else placements(mesh, out_specs))
    varying = {mesh.mesh_dim_names[i] for s in in_specs
               for i, p in enumerate(placements(mesh, s)) if p.is_shard()}
    mapped = local_map(f, out_placements=outs,
                       in_placements=tuple(placements(mesh, s)
                                           for s in in_specs),
                       in_grad_placements=tuple(
                           _grad_placements(mesh, s, varying)
                           for s in in_specs),
                       device_mesh=mesh, redistribute_inputs=True)

    def run(*args):
        return mapped(*(to_dtensor(a, mesh, s)
                        for a, s in zip(args, in_specs)))
    return run


# --------------------------------------------------------------------- #
# collectives over one mesh axis
# --------------------------------------------------------------------- #


def _group(axis: str, mesh=None):
    mesh = mesh if mesh is not None else get_mesh()
    return mesh.get_group(axis)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x)


def _all_reduce(x: torch.Tensor, op: str, axis: str, mesh=None
                ) -> torch.Tensor:
    import torch.distributed._functional_collectives as fc
    return fc.wait_tensor(fc.all_reduce(x, op, _group(axis, mesh)))


class _PSum(torch.autograd.Function):
    """The sum over an axis; its result is the same on every rank of the
    axis, so each rank's cotangent is already the total: the backward
    passes it through (JAX's transpose of ``psum``, Megatron's reduce
    from the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _all_reduce(x, "sum", axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def stage_cuda_all_gather() -> None:
    """Route the functional all-gather of CUDA tensors through pinned
    host memory, for the rest of the process: DTensor gathers shards
    with it (``full_tensor``, a shard made whole), and ``gloo``'s form
    of it kills the process on CUDA tensors (SIGSEGV, torch 2.11 on an
    H100; its all-reduce, reduce-scatter and all-to-all run there).
    Ranks of a ``gloo`` group on CUDA call it once
    (``launch.mesh.init_rank``); each staged gather counts in
    ``HOST_STAGED``."""
    global _STAGED_GATHER
    if _STAGED_GATHER is not None:
        return
    ops = torch.ops._c10d_functional

    def gather(x, group_size, group_name):
        HOST_STAGED["all_gather"] += 1
        out = ops.all_gather_into_tensor(_to_host(x), group_size,
                                         group_name)
        return ops.wait_tensor(out).to(x.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    _STAGED_GATHER = lib


def pmax(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``lax.pmax``: the elementwise max over the ranks of ``axis``."""
    return _all_reduce(x, "max", axis, mesh)


def psum(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``lax.psum``: the elementwise sum over the ranks of ``axis``
    (differentiable)."""
    return _PSum.apply(x, axis, mesh)


def all_to_all(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0)``: ``x``'s leading dimension has
    one block per rank of ``axis``; block i goes to rank i, and the
    result's block j came from rank j.  Differentiable (the backward is
    the reverse exchange)."""
    import torch.distributed._functional_collectives as fc
    return fc.all_to_all_single_autograd(x, None, None, _group(axis, mesh))


def axis_index(axis: str, mesh=None) -> int:
    """``lax.axis_index``: this rank's index along ``axis``, which is its
    rank in the axis's process group, the order ``all_to_all`` splits
    blocks in."""
    return dist.get_rank(_group(axis, mesh))


# --------------------------------------------------------------------- #
# plain tensors beside DTensors
# --------------------------------------------------------------------- #


@contextlib.contextmanager
def spmd_scope():
    """Plain tensors that meet DTensors count as replicated on every
    rank (DTensor's ``implicit_replication``), for the duration of the
    outermost scope; no effect before ``torch.distributed`` starts."""
    global _IN_SCOPE
    if _IN_SCOPE or not (dist.is_available() and dist.is_initialized()):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _IN_SCOPE = True
    try:
        with implicit_replication():
            yield
    finally:
        _IN_SCOPE = False


def spmd(fn):
    """Run ``fn`` under ``spmd_scope``."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with spmd_scope():
            return fn(*args, **kw)
    return wrapped


def replicated(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` replicated over mesh axis ``axis`` where it is a DTensor
    sharded there (a plain tensor as it is)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    i = x.device_mesh.mesh_dim_names.index(axis)
    if x.placements[i].is_replicate():
        return x
    pl = list(x.placements)
    pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def placed_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` under ``ref``'s placements where ``ref`` is a DTensor (a
    gradient, which may be a partial sum, under its parameter's)."""
    if is_dtensor(ref) and tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def _reshape_dtensor(x, shape):
    from torch.distributed.tensor import Replicate
    src = list(x.shape)
    known = math.prod(d for d in shape if d != -1)
    dst = [math.prod(src) // known if d == -1 else d for d in shape]
    i = 0
    while i < min(len(src), len(dst)) and src[i] == dst[i]:
        i += 1
    j = 0
    while (j < min(len(src), len(dst)) - i
           and src[len(src) - 1 - j] == dst[len(dst) - 1 - j]):
        j += 1
    changed, into = range(i, len(src) - j), dst[i:len(dst) - j]
    sharded = {p.dim for p in x.placements if p.is_shard()}
    pl = list(x.placements)
    for m, p in enumerate(pl):
        if not (p.is_shard() and p.dim in changed):
            continue
        n = x.device_mesh.size(m)
        split = len(changed) == 1 and len(into) > 1 and into[0] % n == 0
        merge = (len(into) == 1 and src[i] % n == 0
                 and not sharded & set(changed[1:]))
        if not (p.dim == i and (split or merge)):
            pl[m] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward reshapes the gradient by the
    same rule (the gradient may arrive sharded where the output was
    not)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.src), None


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``.  A DTensor sharded on a dimension that the
    reshape splits or merges stays sharded where DTensor can keep it (a
    split whose first factor, or a merge whose first dimension, is that
    dimension and divides its axis; no other merged dimension sharded);
    otherwise that axis is replicated first, explicitly, in the forward
    and in the backward: DTensor refuses such a view rather than
    redistribute, where GSPMD reshards.  Attention's head split of 15
    heads over 2 ranks is one."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def plain_like(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out`` as a plain tensor (its global value, gathered where it is
    sharded) where the region's input ``x`` was a plain tensor: a caller
    whose activations are plain tensors (the serving engine over a mesh)
    gets plain tensors back; a DTensor caller keeps DTensors."""
    if is_dtensor(out) and not is_dtensor(x):
        return out.full_tensor()
    return out


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor; false at once while no process group
    is up (no mesh, so no DTensor), which keeps the single-device model
    path free of the DTensor import."""
    if not dist.is_initialized():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
