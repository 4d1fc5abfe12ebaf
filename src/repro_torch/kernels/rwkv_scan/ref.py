"""Plain PyTorch versions of the WKV6 recurrence (RWKV6's time-mix core)

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t S_{t-1} + (r_t . u . k_t) v_t

per (batch, head), with a D x D fp32 state S.

* ``wkv6_reference`` is the per-token oracle, the port's copy of
  ``repro.kernels.rwkv_scan.ref.wkv6_reference`` (initial state ``s0``
  included).
* ``wkv6_chunked_ref`` is the closed chunked form that the JAX model runs
  (``repro.models.rwkv.rwkv_time_mix_full``): within a chunk of Q steps,
  cumulative decays ``W_t = prod_{s<=t} w_s`` give
      y_t = (r_t . W_{t-1}) S_0 + sum_{s<t} <r_t . W_{t-1}/W_s, k_s> v_s
            + <r_t . u, k_t> v_t
      S_Q = diag(W_Q) S_0 + sum_s diag(W_Q/W_s) k_s^T v_s
  with the same log/cumsum/exp, einsums, strict-lower mask and carry, so
  its rounding stays close to the JAX model's.  It is what
  ``ops.wkv6`` runs for CPU tensors.  With ``log_quotients`` (training:
  ``models.rwkv`` ``scan="chunked"``) it takes its two quotients by the
  cumulative decay in log space, ``k_s / W_s`` as ``k_s exp(-log W_s)``
  and ``W_Q / W_s`` as ``exp(log W_Q - log W_s)``: the same values to
  rounding, but a backward with no ``W_s ** 2``, which underflows fp32
  once a channel decays below ~1e-19 within a chunk and turns the direct
  form's gradients (and JAX's) to inf and NaN.

Both are what ``chip_smoke.py`` and the CUDA tests hold the kernel
against on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   s0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B,S,H,D) fp32 (w in (0,1)); u: (H,D); s0: (B,H,D,D).
    Returns (y (B,S,H,D), S_last (B,H,D,D)), one token at a time."""
    B, S, H, D = r.shape
    Sm = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
          if s0 is None else s0)
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B,H,D)
        y = torch.einsum("bhd,bhde->bhe", rt, Sm)
        y = y + torch.einsum("bhd,bhd->bh", rt * u[None], kt)[..., None] * vt
        Sm = wt[..., None] * Sm + torch.einsum("bhd,bhe->bhde", kt, vt)
        ys.append(y)
    return torch.stack(ys, dim=1), Sm


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor], chunk: int,
                     log_quotients: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The closed chunked form over chunks of ``chunk`` steps (it must
    divide S; the model takes ``models.ssm.pick_chunk(S, 64)``).  Same
    arguments and results as ``wkv6_reference``; ``log_quotients`` (the
    differentiable training form) is in the module docstring."""
    B, S, H, D = r.shape
    Q = chunk
    if Q < 1 or S % Q:
        raise ValueError(f"chunk {Q} does not divide the sequence length {S}")
    nc = S // Q
    if s0 is None:
        s0 = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)

    def as_chunks(t):                                   # (nc, B, H, Q, D)
        return t.reshape(B, nc, Q, H, D).permute(1, 0, 3, 2, 4)

    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    S0, ys = s0, []
    for rq, kq, vq, wq in zip(*map(as_chunks, (r, k, v, w))):
        logW = torch.cumsum(torch.log(wq), dim=2)       # (B,H,Q,D)
        W = torch.exp(logW)
        Wm1 = torch.exp(logW - torch.log(wq))           # W_{t-1} = W_t / w_t
        # inter-chunk: y_inter[t] = (r_t . W_{t-1}) @ S0
        y_inter = torch.einsum("bhqd,bhde->bhqe", rq * Wm1, S0)
        WQ = W[:, :, -1]                                # (B,H,D)
        if log_quotients:
            k_over_W = kq * torch.exp(-logW)
            WQ_over_W = torch.exp(logW[:, :, -1:] - logW)
        else:
            k_over_W = kq / W
            WQ_over_W = WQ[:, :, None, :] / W
        # intra-chunk, strictly lower triangular
        att = torch.einsum("bhqd,bhsd->bhqs", rq * Wm1, k_over_W)
        att = torch.where(tri[None, None], att, 0.0)
        y_intra = torch.einsum("bhqs,bhse->bhqe", att, vq)
        # current-token bonus
        y_diag = torch.einsum("bhqd,bhqd->bhq", rq * u[None, :, None, :],
                              kq)[..., None] * vq
        # carry: S_Q = diag(W_Q) S0 + sum_s diag(W_Q/W_s) k_s^T v_s
        S0 = WQ[..., None] * S0 + torch.einsum(
            "bhsd,bhse->bhde", kq * WQ_over_W, vq)
        ys.append(y_inter + y_intra + y_diag)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H, D)
    return y, S0
