"""Plain PyTorch reference of the served models, in float32 with TF32 off.

It recomputes whole sequences from their tokens: embedding, every layer
(RMSNorm, q/k/v projections, Qwen3's per-head q/k norm, rotary embedding
on the two halves of each head, causal grouped-query attention with
softmax in float32, the output projection, then the gated SiLU MLP or the
MoE layer) and the output head.  The MoE layer routes each token to its
top-k experts by the router's logits (the padding experts masked out),
softmaxes those k logits, and sums the k experts' outputs with the
sigmoid-gated shared expert; each expert only sees its own tokens.

``quant="fp8"`` is the control: every projection's input (per row) and
weight (per output column) rounded to float8 e4m3 with an amax scale, as
an fp8 serving path would compute them; router, shared-expert gate,
attention and head stay in float32.  The router stays because fp8 serving
paths leave it unquantised (vLLM's Qwen2-MoE builds its gate and the
shared expert's gate with no quantisation), so the step that would tempt
a later change is the projections and experts, not the routing.

Weights come through ``reference.adapter`` as float32 tensors; nothing
here imports the port.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
Q_BLOCK = 1024          # query rows per attention block


def exact_fp32() -> None:
    """No TF32 anywhere: the reference's products are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x (..., in) @ w (in, out)."""
    if quant == "fp8":
        x, w = fake_fp8(x, -1), fake_fp8(w, -2)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), pos (S,): rotate the pairs (i, i + D/2)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = (pos.to(torch.float64)[:, None] * inv[None, :]).to(torch.float32)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(m, W, h: torch.Tensor, quant) -> torch.Tensor:
    """One sequence's causal GQA attention; h (S, d) normed input."""
    S = h.shape[0]
    H, Hkv, D = m.num_heads, m.num_kv_heads, m.head_dim
    q = mm(h, W["wq"], quant).view(S, H, D)
    k = mm(h, W["wk"], quant).view(S, Hkv, D)
    v = mm(h, W["wv"], quant).view(S, Hkv, D)
    if m.qk_norm:
        q = rms_norm(q, W["q_norm"], m.norm_eps)
        k = rms_norm(k, W["k_norm"], m.norm_eps)
    pos = torch.arange(S, device=h.device)
    q, k = rope(q, pos, m.rope_theta), rope(k, pos, m.rope_theta)
    G = H // Hkv
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)        # (H, S, D)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty(H, S, D, dtype=torch.float32, device=h.device)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        s = (q[:, a:b] @ k[:, :b].transpose(1, 2)) / math.sqrt(D)
        mask = pos[a:b, None] >= pos[None, :b]
        s = s.masked_fill(~mask, float("-inf"))
        out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, :b]
    return mm(out.transpose(0, 1).reshape(S, H * D), W["wo_attn"], quant)


def mlp(W, h: torch.Tensor, quant, pre: str = "") -> torch.Tensor:
    g = mm(h, W[pre + "wi_gate"], quant)
    u = mm(h, W[pre + "wi_up"], quant)
    return mm(F.silu(g) * u, W[pre + "wo"], quant)


def moe(m, W, h: torch.Tensor, quant) -> torch.Tensor:
    logits = h @ W["router"]                                 # (T, E)
    logits[:, m.num_experts:] = float("-inf")
    topv, topi = torch.topk(logits, m.experts_per_token, dim=-1)
    wts = torch.softmax(topv, dim=-1)
    y = torch.zeros_like(h)
    for e in range(m.num_experts):
        rows, slot = torch.nonzero(topi == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = h[rows]
        ye = mm(F.silu(mm(xe, W["e_wi_gate"][e], quant))
                * mm(xe, W["e_wi_up"][e], quant), W["e_wo"][e], quant)
        y.index_add_(0, rows, ye * wts[rows, slot][:, None])
    if m.num_shared_experts:
        gate = torch.sigmoid(h @ W["shared_gate"])
        y = y + gate * mlp(W, h, quant, pre="s_")
    return y


def block(m, W, x: torch.Tensor, lens: List[int], quant) -> torch.Tensor:
    """One layer over the concatenated sequences x (sum(lens), d)."""
    h = rms_norm(x, W["ln1"], m.norm_eps)
    att, a = [], 0
    for n in lens:
        att.append(attention(m, W, h[a:a + n], quant))
        a += n
    x = x + torch.cat(att)
    h = rms_norm(x, W["ln2"], m.norm_eps)
    return x + (moe(m, W, h, quant) if m.num_experts else mlp(W, h, quant))


@torch.no_grad()
def logits_at(m, weights, seqs: List[torch.Tensor], picks: List[torch.Tensor],
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """Float32 logits over the real vocabulary at positions ``picks[i]`` of
    each token sequence ``seqs[i]``, layer by layer over all sequences."""
    lens = [int(s.numel()) for s in seqs]
    x = weights.embed(torch.cat(seqs))
    for layer in range(m.num_layers):
        x = block(m, weights.layer(layer), x, lens, quant)
    x = rms_norm(x, weights.final_norm(), m.norm_eps)
    head = weights.head()
    out, a = [], 0
    for n, p in zip(lens, picks):
        out.append(x[a:a + n][p] @ head.T)
        a += n
    return out
