"""Flash-decode over a sequence-sharded KV cache:
``repro.distributed.collectives`` on ``torch.distributed``.

Decode attention is memory-bandwidth-bound, so the KV cache's SEQUENCE
dimension is sharded over the ``model`` axis: k ranks stream k times the
bandwidth, each computes the softmax partials of its slice, and one
``pmax`` (the running max) and two ``psum``s (sum-of-exp, numerator)
combine them.  This is flash-decoding as collectives over a mesh axis
instead of split-k blocks on one card.

* ``decode_attn_partials``: single-device decode attention that also
  returns the softmax's running max ``m`` and sum-exp ``l``, so a caller
  can merge more softmax groups into it (the deferred-append decode,
  ``models.attention.attention_decode_deferred``).
* ``flash_decode_seqsharded`` / ``_partials``: the per-rank body inside
  a sharded region (``context.shard_map_compat``).
* ``make_seqsharded_decode_attn`` / ``_partials``: the region over a
  mesh: full (or DTensor) arrays in, the cache sharded over the sequence
  inside, DTensors out.
* ``decode_attn_reference``: the single-device fp32 oracle.
* ``embedding``: ``F.embedding``, as Megatron's vocab-parallel lookup
  when the table is a DTensor sharded on its rows.

Products are formed in fp32 (bf16 products are exact there: JAX's
``preferred_element_type=float32``), with the softmax weights cast to
the value dtype before the PV product, as in JAX.  Every product is a
plain einsum: the JAX package computes these outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import (P, axis_index, axis_size,
                                             dp_axes_of, is_dtensor, pmax,
                                             psum, shard_map_compat, spec_of)

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """q (B,H,D), k (B,S,Hkv,D), valid (B,S) -> masked fp32 scores
    (B, Hkv, G, S)."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D).to(k.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    s = s / math.sqrt(D)
    return s.masked_fill(~valid[:, None, None, :], NEG_INF)


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())


def decode_attn_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention returning (out, running max m, sum-exp l) so a
    caller can merge additional softmax groups (deferred-append decode).
    q (B,H,D); k/v (B,S,Hkv,D); valid (B,S) -> out (B,H,D) fp32, m/l
    (B,H) fp32."""
    B, H, D = q.shape
    s = _scores(q, k, valid)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = _pv(p, v) / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def flash_decode_seqsharded(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid: torch.Tensor, *,
                            axis_name: str, mesh=None) -> torch.Tensor:
    """One-token decode attention over a sequence-sharded KV cache.

    Inside a sharded region: q (B, H, D) replicated over ``axis_name``;
    k/v (B, S_local, Hkv, D) hold this rank's slice of the sequence;
    valid (B, S_local) marks real entries.  Returns (B, H, D) (full).
    """
    return flash_decode_seqsharded_partials(
        q, k, v, valid, axis_name=axis_name, mesh=mesh)[0].to(q.dtype)


def flash_decode_seqsharded_partials(q, k, v, valid, *, axis_name: str,
                                     mesh=None):
    """Sequence-sharded flash decode returning global (out, m, l)."""
    B, H, D = q.shape
    s = _scores(q, k, valid)
    m = pmax(s.amax(dim=-1), axis_name, mesh)            # (B, Hkv, G)
    p = torch.exp(s - m[..., None])
    l = psum(p.sum(dim=-1), axis_name, mesh)
    acc = psum(_pv(p, v), axis_name, mesh)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def _seqsharded(mesh, seq_axis: str, body, out_specs):
    """The sharded region of both wrappers: each rank's valid mask is
    ``idx * S_local + arange(S_local) < lengths``."""
    dp = dp_axes_of(mesh)
    n = axis_size(mesh, seq_axis)

    def fn(q, k, v, lengths):
        S_local = k.shape[1] // n

        def local(qs, ks, vs, ln):
            idx = axis_index(seq_axis, mesh)
            pos = idx * S_local + torch.arange(S_local,
                                               device=ks.device)[None, :]
            valid = pos < ln[:, None]
            return body(qs, ks, vs, valid, axis_name=seq_axis, mesh=mesh)

        return shard_map_compat(
            local, mesh=mesh,
            in_specs=(P(dp, None, None), P(dp, seq_axis, None, None),
                      P(dp, seq_axis, None, None), P(dp)),
            out_specs=out_specs(dp),
        )(q, k, v, lengths)

    return fn


def make_seqsharded_decode_attn(mesh, *, seq_axis: str = "model"):
    """Full arrays in, sequence sharded internally.

    q (B, H, D); k/v (B, S, Hkv, D) sharded P(dp, seq, None, None);
    lengths (B,) = valid context per request.  Returns (B, H, D).
    """
    return _seqsharded(mesh, seq_axis, flash_decode_seqsharded,
                       lambda dp: P(dp, None, None))


def make_seqsharded_decode_attn_partials(mesh, *, seq_axis: str = "model"):
    """The partials variant (full arrays in; out, m, l out)."""
    return _seqsharded(mesh, seq_axis, flash_decode_seqsharded_partials,
                       lambda dp: (P(dp, None, None), P(dp, None),
                                   P(dp, None)))


def seqsharded_write(mesh, buf: torch.Tensor, rows: torch.Tensor,
                     slot: torch.Tensor, *, seq_axis: str = "model"):
    """Write one new entry per batch row into a sequence-sharded cache:
    buf (..., B, S, Hkv, D) (a leading L axis allowed), sharded P(...,
    dp, seq, None, None); rows (..., B, Hkv, D); slot (B,) the global
    slot.  Shard-local: only the rank that owns ``slot`` writes, at
    ``slot - idx * S_local``; the others write back what they hold.
    Returns the new cache as a DTensor under the same spec."""
    dp = dp_axes_of(mesh)
    lead = (None,) * (buf.ndim - 4)

    def local(b, r, sl):
        S_local = b.shape[-3]
        ls = sl.long() - axis_index(seq_axis, mesh) * S_local
        owned = (ls >= 0) & (ls < S_local)
        at = (slice(None),) * len(lead) + (
            torch.arange(b.shape[-4], device=b.device),
            torch.clamp(ls, 0, S_local - 1))
        out = b.clone()
        out[at] = torch.where(owned[:, None, None], r, b[at])
        return out

    spec = P(*lead, dp, seq_axis, None, None)
    return shard_map_compat(
        local, mesh=mesh, in_specs=(spec, P(*lead, dp, None, None), P(dp)),
        out_specs=spec)(buf, rows, slot)


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; where either is a DTensor, ``F.embedding``,
    which DTensor shards (advanced indexing it does not).  Over a table
    sharded on its rows over a mesh axis, each rank looks up the tokens
    of its own vocab slice (zeros for the others) and one ``psum`` over
    the axis completes every row: the vocab-parallel lookup.  It is
    written out because DTensor's own sharding of ``aten.embedding``
    mis-reduces its masked partial sum when the tokens are sharded over
    ``data``.  The sum adds one value to zeros, so every row is the
    table's bits."""
    if not (is_dtensor(table) or is_dtensor(tokens)):
        return table[tokens]
    if not is_dtensor(table) or not any(p.is_shard(0)
                                        for p in table.placements):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    axis = next(n for n, p in zip(mesh.mesh_dim_names, table.placements)
                if p.is_shard(0))
    tok = spec_of(tokens)

    def local(t, rows):
        V = rows.shape[0]
        t = t - axis_index(axis, mesh) * V
        inside = (t >= 0) & (t < V)
        out = F.embedding(torch.clamp(t, 0, V - 1), rows) \
            * inside[..., None].to(rows.dtype)
        return psum(out, axis, mesh)

    return shard_map_compat(local, mesh=mesh,
                            in_specs=(tok, P(axis, None)),
                            out_specs=P(*tok, None))(tokens, table)


# --------------------------------------------------------------------- #
# reference (single-device oracle)
# --------------------------------------------------------------------- #

def decode_attn_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q (B,H,D); k/v (B,S,Hkv,D); lengths (B,) -> (B,H,D), fp32 softmax."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) / math.sqrt(D)
    valid = torch.arange(S, device=k.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v.float())
    return out.reshape(B, H, D).to(q.dtype)
