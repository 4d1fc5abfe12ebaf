"""Selective-SSM (Mamba-style) branch of the hybrid (hymba) layer: the
port of ``repro.models.ssm``.

State: ``h (B, d_inner, N)`` with per-channel data-dependent decay
``a_t = exp(dt_t * A)`` and input injection ``b_t = dt_t * B_t * x_t``:
``h_t = a_t * h_{t-1} + b_t``, ``y_t = h_t @ C_t + D * x_t``.

The full-sequence form walks time in chunks of at most ``chunk`` steps,
carrying h across chunks, and scans each chunk in log depth: torch has
no ``associative_scan``, so ``_ssm_core_scan`` is the doubling
(Hillis-Steele) scan, ``ceil(log2 Q)`` rounds of ``(a_l * a_r,
a_r * b_l + b_r)`` over the whole chunk, where a loop of Q steps would
put Q x a few nodes per layer into a prefill round's step graph.  The
JAX package runs this scan outside any Pallas kernel, and so does the
port: it is plain torch on every device.  The scan writes its operands
in place, so where a gradient is needed ``chunk_scan`` runs it through
``ChunkScan``, an autograd function that scans private copies, keeps
only ``a`` and the output, and differentiates by the same doubling scan
run backward in time.  Decode is the O(1) state
update.  A short causal depthwise conv (kernel 4) precedes the SSM as
in Mamba; its 3-sample state is carried in the cache for decode.  h
stays fp32 and the conv window in the model dtype, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Params, dense_init

CONV_K = 4


def pick_chunk(S: int, pref: int) -> int:
    """Largest power-of-two divisor of S that is <= pref (>= 1)."""
    if S <= pref:  # repro: allow-recompile-hazard(S and pref are static Python ints from .shape; chunk picking is trace-time shape arithmetic)
        return S
    q = pref
    while q > 1 and S % q != 0:  # repro: allow-recompile-hazard(same trace-time shape arithmetic as above)
        q //= 2
    return max(q, 1)


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    """One layer's SSM leaves (stacked on ``lead``) with ``repro``'s
    shapes, dtypes and init scales: projections N(0, 1/in_dim), the conv
    taps N(0, 0.2^2), ``dt_bias`` 0 in ``dtype``; ``A_log = log(1..N)``
    per channel and ``D = 1`` in fp32."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dev = gen.device
    conv = torch.randn(lead + (CONV_K, di), generator=gen, device=dev,
                       dtype=torch.float32) * 0.2
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=dev)).expand(lead + (di, N))
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype, lead),   # x, z gate
        "conv_w": conv.to(dtype),
        "dt_proj": dense_init(gen, di, di, dtype, lead),
        "dt_bias": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "bc_proj": dense_init(gen, di, 2 * N, dtype, lead),   # B_t, C_t
        "A_log": a_log.clone(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype, lead),
    }


def _conv_full(xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, di)."""
    pad = F.pad(xin, (0, 0, CONV_K - 1, 0))
    return _conv_window(pad, w, xin.shape[1])


def _conv_window(stream: torch.Tensor, w: torch.Tensor,
                 S: int) -> torch.Tensor:
    """Causal depthwise conv over a stream that already carries the
    CONV_K-1 samples of left context; returns the last S outputs."""
    out = stream[:, 0:S] * w[0]
    for i in range(1, CONV_K):
        out = out + stream[:, i:i + S] * w[i]
    return out


def _ssm_core_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along dim 1 (time),
    h_{-1} = 0: the doubling scan, ``ceil(log2 Q)`` rounds in which step
    t >= s combines with step t - s.  Overwrites ``a`` and ``b`` (the
    caller's fresh tensors); returns ``b`` holding every h_t."""
    Q = a.shape[1]
    s = 1
    while s < Q:
        # every right-hand side is a fresh tensor of the old values, so
        # the in-place writes below never read what they overwrite
        b[:, s:] += a[:, s:] * b[:, :Q - s]
        if 2 * s < Q:                       # the last round needs no a
            a[:, s:] = a[:, s:] * a[:, :Q - s]
        s *= 2
    return b


class ChunkScan(torch.autograd.Function):
    """``_ssm_core_scan`` under autograd: h_t = a_t * h_{t-1} + b_t over
    dim 1 with h_{-1} = 0 (a chunk's carry is already in b_0).

    The forward scans private copies, so its values are bit-equal to the
    in-place scan, and keeps ``a`` and ``h`` for the backward.  With
    g_t = dL/dh_t, the adjoint lam_t = g_t + a_{t+1} * lam_{t+1} (lam_{Q-1}
    = g_{Q-1}) is the same recurrence on reversed time, so the backward
    is the doubling scan on the flipped tensors; then dL/db_t = lam_t and
    dL/da_t = lam_t * h_{t-1}, which is 0 at t = 0."""

    @staticmethod
    def forward(ctx, a, b):
        h = _ssm_core_scan(a.clone(), b.clone())
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        # reversed step r = Q-1-t takes a_{t+1}; step 0's factor meets
        # the zero state and is never read into the sums
        a_rev = torch.empty_like(a)
        a_rev[:, 0] = 0.0
        a_rev[:, 1:] = a[:, 1:].flip(1)
        lam = _ssm_core_scan(a_rev, g.flip(1)).flip(1)
        da = torch.zeros_like(a)
        torch.mul(lam[:, 1:], h[:, :-1], out=da[:, 1:])
        return da, lam


def chunk_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every h_t of one chunk: ``ChunkScan`` where autograd records the
    call, else the in-place ``_ssm_core_scan`` on the caller's fresh
    ``a`` and ``b`` (serving: no copies, the values bit-equal)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return ChunkScan.apply(a, b)
    return _ssm_core_scan(a, b)


def apply_ssm_full(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   chunk: int = 128,
                   state: Optional[Dict[str, torch.Tensor]] = None,
                   length: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y (B, S, d), final state {"h", "conv"}).

    Time is processed in chunks of at most ``chunk`` steps, so the
    per-step state (di, N) is materialized for one chunk at a time: a
    doubling scan within the chunk and a loop carrying h across chunks.
    JAX cuts S into ``pick_chunk(S, chunk)`` equal chunks, which is 1 for
    an odd S (S steps of its ``lax.scan``); the port cuts it into
    ``ceil(S / chunk)`` chunks, the last one shorter.  The recurrence is
    the same, only the rounding order differs.  ``state`` (from a
    previous chunk / ``init_ssm_state``) makes this a continuation, the
    engine's chunked prefill.

    ``length`` (B,) marks only the first ``length[b]`` steps of row b as
    real: trailing steps are shape padding whose state update is the
    identity (dt = 0, so a = 1 and b = 0) and whose samples never enter
    the carried conv window (the last CONV_K-1 *valid* stream samples),
    so a row's final state equals the unpadded run's (length 0 = an
    untouched row)."""
    B, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    xz = x @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)                    # (B, S, di)
    conv_prev = (state["conv"].to(xin.dtype) if state is not None
                 else xin.new_zeros((B, CONV_K - 1, di)))
    stream = torch.cat([conv_prev, xin], dim=1)
    if length is None:
        new_conv = stream[:, S:]
    else:
        idx = (length.long()[:, None]
               + torch.arange(CONV_K - 1, device=x.device)[None, :])
        new_conv = torch.take_along_dim(
            stream, idx[:, :, None].expand(B, CONV_K - 1, di), dim=1)
    xin = F.silu(_conv_window(stream, params["conv_w"], S))

    dt = F.softplus((xin @ params["dt_proj"]).float()
                    + params["dt_bias"].float())            # (B, S, di)
    if length is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < length[:, None])                          # (B, S)
        dt = torch.where(valid[..., None], dt, 0.0)
    bc = (xin @ params["bc_proj"]).float()
    Bt, Ct = torch.chunk(bc, 2, dim=-1)                      # (B, S, N)
    A = -torch.exp(params["A_log"])                          # (di, N)
    xf = xin.float()

    h = (state["h"] if state is not None
         else x.new_zeros((B, di, N), dtype=torch.float32))
    ys = []
    for t0 in range(0, S, chunk):
        sl = slice(t0, min(t0 + chunk, S))
        dt_q = dt[:, sl]
        a = torch.exp(dt_q[..., None] * A)                   # (B, Q, di, N)
        b = (dt_q * xf[:, sl])[..., None] * Bt[:, sl, None, :]
        # inject the carry (b is a product's output, which autograd does
        # not save; a stays as exp saved it: chunk_scan copies it)
        b[:, 0] += a[:, 0] * h
        hs = chunk_scan(a, b)
        ys.append(torch.einsum("bqdn,bqn->bqd", hs, Ct[:, sl]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + params["D"] * xf
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], {"h": h, "conv": new_conv}


def init_ssm_state(cfg: ModelConfig, batch: int, *,
                   device="cuda") -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, cfg.d_inner),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def apply_ssm_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     state: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d), state from init/prior step -> (y (B, 1, d), state)."""
    xz = x[:, 0] @ params["in_proj"]
    xin_new, z = torch.chunk(xz, 2, dim=-1)                  # (B, di)
    window = torch.cat([state["conv"], xin_new[:, None]], dim=1)
    xin = F.silu(torch.einsum("bkd,kd->bd", window, params["conv_w"]))

    dt = F.softplus((xin @ params["dt_proj"]).float()
                    + params["dt_bias"].float())
    bc = (xin @ params["bc_proj"]).float()
    Bt, Ct = torch.chunk(bc, 2, dim=-1)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt[..., None] * A)                         # (B, di, N)
    b = (dt * xin.float())[..., None] * Bt[:, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Ct) + params["D"] * xin.float()
    y = y.to(x.dtype) * F.silu(z)
    return (y @ params["out_proj"])[:, None], {"h": h, "conv": window[:, 1:]}
