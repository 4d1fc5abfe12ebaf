"""Plain PyTorch version of the flash-attention kernel: the port's copy of
``repro.kernels.flash_attention.ref.attention_reference``.

It is what ``ops.flash_attention`` runs for CPU tensors, and what
``chip_smoke.py`` and the CUDA tests hold the kernel against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def visible(S: int, *, causal: bool = True, window: int = 0,
            prefix_len: int = 0, device=None) -> torch.Tensor:
    """Boolean (S, S) mask, [query, key]: which keys each query sees."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    if not causal:
        return torch.ones((S, S), dtype=torch.bool, device=device)
    mask = qp >= kp
    if window:
        mask &= (qp - kp) < window
    if prefix_len:
        mask |= kp < prefix_len
    return mask


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        prefix_len: int = 0) -> torch.Tensor:
    """q (B,S,H,D); k,v (B,S,Hkv,D) -> (B,S,H,D).  Query head h reads kv
    head h // G; scores and softmax in fp32 with scale 1/sqrt(D); masked
    keys get -1e30."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s / math.sqrt(D)
    mask = visible(S, causal=causal, window=window, prefix_len=prefix_len,
                   device=q.device)
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, S, H, D)
