"""Decode-attention partials: ``repro.distributed.collectives`` for one
device.

Only ``decode_attn_partials`` is ported: the single-device decode
attention that also returns the softmax's running max ``m`` and sum-exp
``l``, so that a caller can merge more softmax groups into it (the
deferred-append decode, ``models.attention.attention_decode_deferred``).
The sequence-sharded flash decode and its ``shard_map`` wrappers
(``flash_decode_seqsharded``, ``make_seqsharded_decode_attn*``) need a
mesh and ``torch.distributed``: ROADMAP A13.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def decode_attn_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention returning (out, running max m, sum-exp l) so a
    caller can merge additional softmax groups (deferred-append decode).
    q (B,H,D); k/v (B,S,Hkv,D); valid (B,S) -> out (B,H,D) fp32, m/l
    (B,H) fp32.  Products are formed in fp32 (bf16 products are exact
    there: JAX's ``preferred_element_type=float32``); the weights are cast
    to the value dtype before the PV product, as in JAX."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).to(k.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    s = s / math.sqrt(D)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)
