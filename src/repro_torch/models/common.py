"""Shared layers for the dense model (plain PyTorch on nested dict params).

Functions take and return tensors in the JAX package's layouts: weights
are ``(in, out)`` and applied as ``x @ W``, activations ``(B, S, ...)``.
Random inits draw from an explicit ``torch.Generator`` on the target
device (they cannot reproduce ``jax.random``'s bits; tests that compare
the two packages convert the JAX params with ``model.params_from_jax``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, 1/in_dim) weights of shape ``lead + (in_dim, out_dim)`` (a
    leading ``(L,)`` stacks one per layer)."""
    w = torch.randn(lead + (in_dim, out_dim), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with a zero-centred scale: ``x / rms(x) * (1 + scale)``,
    computed in fp32 and cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> cos/sin of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python-scalar base: a tensor made from it would be a host->device
    # copy, which waits for the device on every call
    freqs = 1.0 / torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S)."""
    d = x.shape[-1]
    cos, sin = rope_angles(positions, d, theta)      # (B, S, d/2)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """positions (B, S) -> (B, S, dim) float32 sinusoidal embedding: the
    sines of ``dim // 2`` frequencies, then their cosines."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def gated_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> Params:
    return {"wi_gate": dense_init(gen, d_model, d_ff, dtype, lead),
            "wi_up": dense_init(gen, d_model, d_ff, dtype, lead),
            "wo": dense_init(gen, d_ff, d_model, dtype, lead)}


def gated_mlp(params: Params, x: torch.Tensor,
              act: str = "silu") -> torch.Tensor:
    gate = x @ params["wi_gate"]
    up = x @ params["wi_up"]
    # jax.nn.gelu defaults to the tanh approximation
    act_out = F.silu(gate) if act == "silu" else F.gelu(gate,
                                                        approximate="tanh")
    return (act_out * up) @ params["wo"]


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """Boolean (..., Sq, Sk) mask.  prefix-LM: keys with pos <
    prefix_len are visible to every query (bidirectional within the
    prefix, and always-visible context for the suffix)."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    if prefix_len:
        m |= k_pos[..., None, :] < prefix_len
    return m


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int) -> torch.Tensor:
    """Mean token loss; labels < 0 are masked.  logits (..., Vpad): the
    padded vocab entries are set to -1e9 so they get no probability."""
    logits = logits.float()
    if logits.shape[-1] > vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= vocab_size
        logits = logits.masked_fill(pad, -1e9)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
