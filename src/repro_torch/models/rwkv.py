"""RWKV6 "Finch" -- attention-free time-mix with data-dependent decay: the
port of ``repro.models.rwkv``.

Recurrence per head (state S in R^{D x D}):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t S_{t-1} + (r_t . u . k_t) v_t        (u = per-channel bonus)

The full-sequence time-mix (prefill, and the serving engine's chunk
rounds, continuing from ``state["S"]``) runs the recurrence through
``kernels.rwkv_scan.ops.wkv6``: the hand-written CUDA kernel on the card,
the JAX model's closed chunked form on the CPU.  That kernel is
forward-only, as JAX's is; training asks for ``scan="chunked"``, the
closed chunked form that the JAX model trains through
(``ref.wkv6_chunked_ref``) under autograd on every device, with its two
quotients by the cumulative decay taken in log space so that the
backward stays finite where JAX's underflows (ROADMAP §C, the
reference's divergences).  Decode is the O(1)
recurrence in plain torch, as in JAX (which has no kernel there).
Data-dependent decay w_t and token-shift mixes follow the Finch low-rank
parameterization (simplified: a single LoRA, for the decay).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv_scan import ops as wkv_ops
from repro_torch.kernels.rwkv_scan.ref import wkv6_chunked_ref
from repro_torch.models.common import Params, dense_init
from repro_torch.models.ssm import pick_chunk

LORA_R = 32


def init_rwkv_layer(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> Params:
    """One layer's time-mix and channel-mix leaves (stacked on ``lead``),
    with ``repro``'s shapes, dtypes and init scales: token-shift mixes
    U(0.25, 0.75) and the decay base, bonus fp32; projections
    N(0, 1/in_dim) and the group-norm scale (0) in ``dtype``."""
    d, dev = cfg.d_model, gen.device

    def uniform_mix(rows):
        u = torch.rand(lead + (rows, d), generator=gen, device=dev)
        return u * 0.5 + 0.25

    def f32(t):
        return t.expand(lead + t.shape).clone()

    return {
        # time-mix
        "mu": uniform_mix(4),
        "wr": dense_init(gen, d, d, dtype, lead),
        "wk": dense_init(gen, d, d, dtype, lead),
        "wv": dense_init(gen, d, d, dtype, lead),
        "wg": dense_init(gen, d, d, dtype, lead),
        "wo": dense_init(gen, d, d, dtype, lead),
        "decay_lora_a": dense_init(gen, d, LORA_R, dtype, lead),
        "decay_lora_b": dense_init(gen, LORA_R, d, dtype, lead),
        "decay_base": f32(torch.linspace(-6.0, -1.0, d, device=dev)),
        "bonus": f32(torch.zeros((d,), device=dev)),
        "ln_x": torch.zeros(lead + (d,), dtype=dtype, device=dev),
        # channel-mix
        "cm_mu": uniform_mix(2),
        "cm_r": dense_init(gen, d, d, dtype, lead),
        "cm_k": dense_init(gen, d, cfg.d_ff, dtype, lead),
        "cm_v": dense_init(gen, cfg.d_ff, d, dtype, lead),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B,S,d), prev (B,1,d) = last token of previous segment."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def init_rwkv_state(cfg: ModelConfig, batch: int, *,
                    device="cuda") -> Dict[str, torch.Tensor]:
    H, D = cfg.ssm_heads, cfg.ssm_state
    dtype = getattr(torch, cfg.dtype)
    return {
        "S": torch.zeros((batch, H, D, D), dtype=torch.float32,
                         device=device),
        "x_tm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                            device=device),
        "x_cm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                            device=device),
    }


def _rkvwg(params: Params, cfg: ModelConfig, x: torch.Tensor,
           shifted: torch.Tensor):
    """Shared projection block. Returns r,k,v (B,S,H,D), w (decay, fp32),
    g."""
    B, S, d = x.shape
    H, D = cfg.ssm_heads, cfg.ssm_state
    mu = params["mu"]
    xr = _mix(x, shifted, mu[0].to(x.dtype))
    xk = _mix(x, shifted, mu[1].to(x.dtype))
    xv = _mix(x, shifted, mu[2].to(x.dtype))
    xw = _mix(x, shifted, mu[3].to(x.dtype))
    r = (xr @ params["wr"]).reshape(B, S, H, D)
    k = (xk @ params["wk"]).reshape(B, S, H, D)
    v = (xv @ params["wv"]).reshape(B, S, H, D)
    g = F.silu(xv @ params["wg"])
    dd = (xw @ params["decay_lora_a"]) @ params["decay_lora_b"]
    logw = params["decay_base"].float() + torch.tanh(dd.float())
    w = torch.exp(-torch.exp(logw)).reshape(B, S, H, D)   # in (0,1)
    return r, k, v, w, g


def _out_norm(params: Params, cfg: ModelConfig, y: torch.Tensor,
              g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-head RMS norm + gate + out projection. y (B,S,H,D) fp32."""
    B, S, H, D = y.shape
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5)
    y = y.reshape(B, S, H * D) * (1.0 + params["ln_x"].float())
    return (y.to(dtype) * g) @ params["wo"]


def rwkv_time_mix_full(params: Params, cfg: ModelConfig, x: torch.Tensor,
                       state: Dict[str, torch.Tensor], chunk: int = 64,
                       length: Optional[torch.Tensor] = None,
                       scan: str = "kernel"
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``length`` (B,) marks only the first ``length[b]`` steps of row b
    as real.  Padded steps are forced to the recurrence identity
    (w = 1, k = 0, so S_t = S_{t-1}) and the carried token-shift sample
    is the last *valid* token (length 0 = untouched row).  The recurrence
    continues from ``state["S"]``.  ``scan`` picks its arithmetic:
    ``"kernel"`` the forward-only ``wkv_ops.wkv6``, ``"chunked"`` the
    closed chunked form in plain torch, differentiable (training)."""
    B, S, d = x.shape
    H, D = cfg.ssm_heads, cfg.ssm_state
    shifted = _token_shift(x, state["x_tm"])
    r, k, v, w, g = _rkvwg(params, cfg, x, shifted)
    if length is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < length[:, None])[..., None, None]
        w = torch.where(valid, w, 1.0)
        k = torch.where(valid, k, torch.zeros_like(k))
    u = torch.exp(params["bonus"]).reshape(H, D)
    if scan == "kernel":
        y, S_last = wkv_ops.wkv6(r, k, v, w, u, s0=state["S"],
                                 chunk=pick_chunk(S, chunk))
    elif scan == "chunked":
        y, S_last = wkv6_chunked_ref(r.float(), k.float(), v.float(), w, u,
                                     state["S"], pick_chunk(S, chunk),
                                     log_quotients=True)
    else:
        raise ValueError(f"unknown scan {scan!r}")
    out = _out_norm(params, cfg, y, g, x.dtype)
    x_tm = _last_valid(x, length, state["x_tm"])
    return out, {"S": S_last, "x_tm": x_tm, "x_cm": state["x_cm"]}


def _last_valid(x: torch.Tensor, length: Optional[torch.Tensor],
                fallback: torch.Tensor) -> torch.Tensor:
    """Token-shift carry: last valid token of x (B,S,d), or ``fallback``
    (B,1,d) for rows with length 0.  length None = whole row valid."""
    if length is None:
        return x[:, -1:]
    B, _, d = x.shape
    last = torch.clamp(length - 1, min=0).long()
    picked = torch.take_along_dim(x, last[:, None, None].expand(B, 1, d),
                                  dim=1)
    return torch.where((length > 0)[:, None, None], picked, fallback)


def rwkv_time_mix_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                         state: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d)."""
    B = x.shape[0]
    H, D = cfg.ssm_heads, cfg.ssm_state
    r, k, v, w, g = _rkvwg(params, cfg, x, state["x_tm"])
    u = torch.exp(params["bonus"]).reshape(H, D)
    r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
    S0 = state["S"]                                          # (B,H,D,D)
    y = torch.einsum("bhd,bhde->bhe", r1, S0)
    y = y + torch.einsum("bhd,bhd->bh", r1 * u[None], k1)[..., None] * v1
    S_new = w1[..., None] * S0 + torch.einsum("bhd,bhe->bhde", k1, v1)
    out = _out_norm(params, cfg, y[:, None].reshape(B, 1, H, D), g, x.dtype)
    return out, {"S": S_new, "x_tm": x, "x_cm": state["x_cm"]}


def rwkv_channel_mix(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     prev: torch.Tensor,
                     length: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-mix FFN with token shift; returns (out, new_prev).
    ``length`` (B,) makes new_prev the last *valid* token per row."""
    shifted = _token_shift(x, prev)
    mu = params["cm_mu"]
    xr = _mix(x, shifted, mu[0].to(x.dtype))
    xk = _mix(x, shifted, mu[1].to(x.dtype))
    rgate = torch.sigmoid((xr @ params["cm_r"]).float()).to(x.dtype)
    kk = torch.square(F.relu(xk @ params["cm_k"]))
    return rgate * (kk @ params["cm_v"]), _last_valid(x, length, prev)
