"""Cost models for batch times (paper §4, Table 3, Eqs. 1-3).

Two models, one interface (``batch_time(BatchSpec) -> seconds``):

* ``TheoreticalCostModel`` — the paper's roofline form
  ``max(FLOPs/GPU_FLOPS, RW/GPU_bandwidth)`` per operator (Eq. 3),
  with the FlashAttention FLOPs/RW of Eqs. 1-2, plus a *collective* term
  (``comm_bytes / link_bw``) absent from the single-GPU paper — on a TPU
  pod, TP all-reduces are first-class costs.
* ``LinearCostModel`` — per-operator linear models over the Table-3
  variables, fitted with least squares against profiled labels
  (``fit_linear_model``).  Monotone by construction (coefficients clipped
  at 0), so it composes into the SLO pareto (§5.3) and the CSP objective
  (§7) exactly as the paper argues.

A ``BatchSpec`` is phase-split: ``prefills`` / ``decodes`` are lists of
``(c, m)`` per request (c = tokens to process now, m = KVs already cached).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig

# --------------------------------------------------------------------- #
# hardware
# --------------------------------------------------------------------- #


@dataclass(frozen=True)
class HardwareConfig:
    name: str
    flops: float          # peak FLOP/s (bf16)
    hbm_bw: float         # bytes/s per chip
    hbm_cap: float        # bytes per chip
    link_bw: float        # bytes/s per interconnect link (ICI / NVLink)
    host_bw: float        # bytes/s host<->device (the swap path, §5.4)
    tp: int = 1           # tensor-parallel degree
    dp: int = 1           # data-parallel degree (for aggregate rooflines)
    bytes_per_el: int = 2  # bf16

    @property
    def chips(self) -> int:
        return self.tp * self.dp

    def with_tp(self, tp: int) -> "HardwareConfig":
        return replace(self, tp=tp)


HARDWARE = {
    # GPU presets reproduce the paper's own numbers (Figs. 4-12).
    "a100": HardwareConfig("a100", 312e12, 2.039e12, 80e9, 300e9, 32e9),
    "h100": HardwareConfig("h100", 989e12, 3.352e12, 80e9, 450e9, 64e9),
    # TPU v5e — the production target of this repo (roofline constants
    # from the assignment: 197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s/link).
    "tpu_v5e": HardwareConfig("tpu_v5e", 197e12, 819e9, 16e9, 50e9, 32e9),
}


def get_hardware(name: str) -> HardwareConfig:
    return HARDWARE[name]


# --------------------------------------------------------------------- #
# batch spec
# --------------------------------------------------------------------- #


@dataclass
class BatchSpec:
    """Phase-split (c, m) pairs for one batch."""

    prefills: List[Tuple[int, int]] = field(default_factory=list)
    decodes: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def total_tokens(self) -> int:
        return (sum(c for c, _ in self.prefills)
                + sum(c for c, _ in self.decodes))

    @property
    def num_requests(self) -> int:
        return len(self.prefills) + len(self.decodes)

    def __bool__(self) -> bool:
        return bool(self.prefills or self.decodes)


# --------------------------------------------------------------------- #
# per-operator FLOPs / RW / comm  (Table 3)
# --------------------------------------------------------------------- #

OPS = ("qkv_proj", "attn_prefill", "attn_decode", "o_proj", "mlp",
       "all_reduce", "others", "head")


def attention_flops_rw(c: int, m: int, cfg: ModelConfig, tp: int,
                       bytes_per_el: int) -> Tuple[float, float]:
    """Paper Eqs. 1-2 for ONE request (B=1), heads sharded over tp.

    FLOPs = 4 c (c+m) H N_Q ;
    RW    = 2 c H N_Q + 2 c (c+m) N_Q + 2 ceil(c/H) (c+m) H N_KV
    (H = head dim; the ceil(c/H) term is the FlashAttention KV re-read per
    query tile).  Sliding-window archs clip the attended span to window.
    """
    H = cfg.head_dim_
    nq = max(1, cfg.num_heads // tp) if cfg.num_heads else 0
    nkv = max(1, cfg.num_kv_heads // tp) if cfg.num_kv_heads else 0
    if nq == 0:
        return 0.0, 0.0
    span = c + m
    if cfg.window:
        span = min(span, cfg.window + c)
    flops = 4.0 * c * span * H * nq
    rw_el = (2.0 * c * H * nq
             + 2.0 * c * span * nq
             + 2.0 * math.ceil(c / H) * span * H * nkv)
    return flops, rw_el * bytes_per_el


def ssm_flops_rw(c: int, cfg: ModelConfig, tp: int,
                 bytes_per_el: int) -> Tuple[float, float]:
    """Recurrent branch (rwkv6 / hymba SSM): state-size-linear in c."""
    if cfg.family == "ssm":          # rwkv: H heads x (D x D) state
        H, D = cfg.ssm_heads, cfg.ssm_state
        state_el = H * D * D / tp
        proj_el = cfg.d_model * cfg.d_model / tp  # r/k/v/g/o projections x5
        flops = c * (2 * 5 * proj_el * tp / tp + 4 * state_el)
        rw = bytes_per_el * (5 * proj_el + c * (2 * state_el + 4 * cfg.d_model))
        return flops, rw
    if cfg.ssm_state:                # hymba mamba branch
        di, N = cfg.d_inner, cfg.ssm_state
        flops = c * (2 * 2 * cfg.d_model * di + 4 * di * N + 2 * di * cfg.d_model) / tp
        rw = bytes_per_el * (3 * cfg.d_model * di / tp
                             + c * (di * N / tp + 4 * cfg.d_model))
        return flops, rw
    return 0.0, 0.0


def op_costs(cfg: ModelConfig, hw: HardwareConfig,
             spec: BatchSpec) -> Dict[str, Tuple[float, float, float]]:
    """Per-operator (FLOPs, RW bytes, comm bytes) for the WHOLE model
    (all layers + LM head), per chip, under TP = hw.tp."""
    tp, bpe = hw.tp, hw.bytes_per_el
    d, L = cfg.d_model, cfg.num_layers
    T = spec.total_tokens
    out: Dict[str, Tuple[float, float, float]] = {}

    has_attn = cfg.num_heads > 0
    qd, kvd = cfg.q_dim, cfg.kv_dim

    # --- qkv / o projections (skip for attention-free archs) ----------- #
    if has_attn:
        w_qkv = d * (qd + 2 * kvd) / tp
        fl = 2.0 * T * w_qkv
        rw = bpe * (w_qkv + T * d + T * (qd + 2 * kvd) / tp)
        out["qkv_proj"] = (L * fl, L * rw, 0.0)
        w_o = qd * d / tp
        fl = 2.0 * T * w_o
        rw = bpe * (w_o + T * qd / tp + T * d)
        out["o_proj"] = (L * fl, L * rw, 0.0)
    else:
        out["qkv_proj"] = (0.0, 0.0, 0.0)
        out["o_proj"] = (0.0, 0.0, 0.0)

    # --- attention (phase-split, per request; Eqs. 1-2) ---------------- #
    for key, items in (("attn_prefill", spec.prefills),
                       ("attn_decode", spec.decodes)):
        fl = rw = 0.0
        for c, m in items:
            if has_attn:
                f, r = attention_flops_rw(c, m, cfg, tp, bpe)
            else:
                f, r = ssm_flops_rw(c, cfg, tp, bpe)
            fl += f
            rw += r
        out[key] = (L * fl, L * rw, 0.0)

    # hybrid archs run BOTH attention and the SSM branch per layer
    if cfg.family == "hybrid":
        fl = rw = 0.0
        for c, _ in spec.prefills + spec.decodes:
            f, r = ssm_flops_rw(c, cfg, tp, bpe)
            fl += f
            rw += r
        f0, r0, _ = out["attn_prefill"]
        out["attn_prefill"] = (f0 + L * fl, r0 + L * rw, 0.0)

    # --- MLP / MoE ------------------------------------------------------ #
    if cfg.num_experts:
        k, ff = cfg.experts_per_token, cfg.moe_d_ff
        e_local = max(1, cfg.padded_experts // tp)
        fl = 2.0 * T * k * 3 * d * ff          # active-expert FLOPs
        fl += cfg.num_shared_experts * 2.0 * T * 3 * d * ff
        fl += 2.0 * T * d * cfg.padded_experts  # router
        fl /= tp
        # weight read: at most all local experts, at most the touched ones
        touched = min(e_local, T * k)
        w_bytes = bpe * (touched + cfg.num_shared_experts) * 3 * d * ff
        rw = w_bytes + bpe * (T * d * 2 + T * k * d / tp)
        out["mlp"] = (L * fl, L * rw, 0.0)
    elif cfg.family == "ssm":
        # rwkv channel-mix: r gate + k/v matmuls
        w = (d * d + 2 * d * cfg.d_ff) / tp
        fl = 2.0 * T * w
        rw = bpe * (w + 2 * T * d + T * cfg.d_ff / tp)
        out["mlp"] = (L * fl, L * rw, 0.0)
    else:
        w = 3.0 * d * cfg.d_ff / tp
        fl = 2.0 * T * w
        rw = bpe * (w + 2 * T * d + T * cfg.d_ff / tp)
        out["mlp"] = (L * fl, L * rw, 0.0)

    # --- TP all-reduce (2 per layer: after attention, after MLP) -------- #
    comm = 0.0
    if tp > 1:
        comm = L * 2.0 * T * d * bpe * 2.0 * (tp - 1) / tp
    out["all_reduce"] = (0.0, 0.0, comm)

    # --- everything else (norms, rope, residuals, sampling) ------------- #
    out["others"] = (L * 10.0 * T * d, L * 6.0 * T * d * bpe, 0.0)

    # --- LM head: only token-emitting positions produce logits ---------- #
    n_logits = len(spec.decodes) + len(spec.prefills)
    w_head = d * cfg.padded_vocab / tp
    fl = 2.0 * n_logits * w_head
    rw = bpe * (w_head + n_logits * (d + cfg.padded_vocab / tp))
    out["head"] = (fl, rw, 0.0)
    return out


# --------------------------------------------------------------------- #
# models
# --------------------------------------------------------------------- #


class CostModel:
    """Interface: batch_time(spec) in seconds, plus the §5.4 preemption
    cost hooks (recompute vs swap) that schedulers and simulators use to
    price a victim's restoration path."""

    def batch_time(self, spec: BatchSpec) -> float:  # pragma: no cover
        raise NotImplementedError

    def op_times(self, spec: BatchSpec) -> Dict[str, float]:  # pragma: no cover
        raise NotImplementedError

    # --- preemption-cost hooks (§5.4 / Fig. 8) ------------------------- #
    def recompute_time(self, n_kvs: int, context: int = 0) -> float:
        """Refill recompute: one prefill of N tokens (§3 refill — the
        cost a discard-preempted request pays on re-admission).
        ``context`` prices a page-level TAIL run: the shed tokens are
        re-prefilled attending over the kept prefix, so a tail
        recompute is costlier per token than a from-scratch refill —
        exactly the asymmetry the per-run swap-vs-recompute crossover
        must see."""
        return self.batch_time(BatchSpec(prefills=[(n_kvs, context)]))

    def kv_projection_time(self, n_kvs: int) -> float:
        """Activation-cached K/V-projection-only rebuild (Fig. 8's
        'recompute' curve).  Models without an operator-level view cannot
        price it separately; default to the realizable full refill."""
        return self.recompute_time(n_kvs)

    def swap_time(self, n_kvs: int) -> float:
        """Host-link transfer time for N KVs (§5.4).  0.0 means 'not
        modeled' — callers (e.g. ``preempt_mode="auto"``) treat that as
        swap-cost-unknown and fall back to recompute."""
        return 0.0


class TheoreticalCostModel(CostModel):
    """Paper Eq. 3 per operator: max(FLOPs/FLOPS, RW/BW) + comm/link_bw.

    ``efficiency`` de-rates peak FLOPS/BW to account for the measured gap
    between theory and practice (Fig. 5-6: attention sits well below the
    roofline); calibrate_efficiency() fits these from profiled samples.
    """

    def __init__(self, cfg: ModelConfig, hw: HardwareConfig, *,
                 flops_eff: float = 1.0, bw_eff: float = 1.0,
                 attn_bw_eff: Optional[float] = None,
                 overhead: float = 0.0):
        self.cfg = cfg
        self.hw = hw
        self.flops_eff = flops_eff
        self.bw_eff = bw_eff
        # Fig. 6: attention under-utilizes bandwidth far more than matmuls
        self.attn_bw_eff = attn_bw_eff if attn_bw_eff is not None else bw_eff
        self.overhead = overhead  # fixed per-batch launch cost (s)

    def op_times(self, spec: BatchSpec) -> Dict[str, float]:
        hw = self.hw
        times: Dict[str, float] = {}
        for op, (fl, rw, comm) in op_costs(self.cfg, hw, spec).items():
            bw_eff = (self.attn_bw_eff if op.startswith("attn")
                      else self.bw_eff)
            t = max(fl / (hw.flops * self.flops_eff),
                    rw / (hw.hbm_bw * bw_eff))
            if comm:
                t = max(t, comm / hw.link_bw)  # overlapped with compute
            times[op] = t
        return times

    def batch_time(self, spec: BatchSpec) -> float:
        if not spec:
            return 0.0
        return sum(self.op_times(spec).values()) + self.overhead

    # --- roofline helpers (§5.2 / Fig. 6) ------------------------------ #
    def batch_terms(self, spec: BatchSpec) -> Dict[str, float]:
        """Aggregate (compute, memory, collective) seconds for the batch."""
        fl = rw = comm = 0.0
        for f, r, c in op_costs(self.cfg, self.hw, spec).values():
            fl += f
            rw += r
            comm += c
        return {
            "compute_s": fl / self.hw.flops,
            "memory_s": rw / self.hw.hbm_bw,
            "collective_s": comm / self.hw.link_bw,
            "flops": fl, "bytes": rw, "comm_bytes": comm,
        }

    def kv_projection_time(self, n_kvs: int) -> float:
        """Activation-cached KV rebuild: only the K/V projections are
        recomputed (the paper's Fig. 8 / §6 'recomputation' — its
        measured t_recom/N in [3.3e-6, 1.3e-3] s is only physically
        possible if layer inputs are cached and the full forward is NOT
        replayed).  Weight-load bias makes per-KV cost FALL with N."""
        L, d, bpe = self.cfg.num_layers, self.cfg.d_model, self.hw.bytes_per_el
        kvd = max(self.cfg.kv_dim, 1)
        flops = L * 2.0 * n_kvs * d * 2 * kvd
        rw = bpe * L * (2 * d * kvd          # K,V projection weights
                        + n_kvs * (d + 2 * kvd))
        return max(flops / (self.hw.flops * self.flops_eff),
                   rw / (self.hw.hbm_bw * self.bw_eff))

    def swap_time(self, n_kvs: int) -> float:
        """Optimal swap-in time for N KVs over the host link (§5.4)."""
        per_tok = self.cfg.kv_bytes_per_token_layer(self.hw.bytes_per_el)
        return n_kvs * per_tok * self.cfg.num_layers / self.hw.host_bw


# --------------------------------------------------------------------- #
# linear (fitted) model — paper §4 "train linear cost models"
# --------------------------------------------------------------------- #

#: feature extractors per operator group (Table 3 variables, all linear)
def _features_nonattn(spec: BatchSpec) -> np.ndarray:
    T = spec.total_tokens
    return np.array([T, 1.0])


def _features_attn_prefill(spec: BatchSpec) -> np.ndarray:
    c2 = sum(float(c) * (c + m) for c, m in spec.prefills)  # ~ c^2 + cm
    c1 = sum(float(c) for c, _ in spec.prefills)
    return np.array([c2, c1, 1.0])


def _features_attn_decode(spec: BatchSpec) -> np.ndarray:
    m1 = sum(float(c + m) for c, m in spec.decodes)  # KVs read
    b = float(len(spec.decodes))
    return np.array([m1, b, 1.0])


def _features_head(spec: BatchSpec) -> np.ndarray:
    return np.array([float(spec.num_requests), 1.0])


FEATURES = {
    "nonattn": _features_nonattn,
    "attn_prefill": _features_attn_prefill,
    "attn_decode": _features_attn_decode,
    "head": _features_head,
}


class LinearCostModel(CostModel):
    """Sum of per-group linear models.  coef[group] @ features(spec)."""

    def __init__(self, coef: Dict[str, np.ndarray]):
        self.coef = {k: np.asarray(v, dtype=np.float64) for k, v in coef.items()}

    def op_times(self, spec: BatchSpec) -> Dict[str, float]:
        return {g: float(np.maximum(self.coef[g], 0.0) @ f(spec))
                for g, f in FEATURES.items()}

    def batch_time(self, spec: BatchSpec) -> float:
        if not spec:
            return 0.0
        return sum(self.op_times(spec).values())

    # persistence ------------------------------------------------------- #
    def to_dict(self) -> Dict[str, list]:
        return {k: v.tolist() for k, v in self.coef.items()}

    @classmethod
    def from_dict(cls, d: Dict[str, Sequence[float]]) -> "LinearCostModel":
        return cls({k: np.asarray(v) for k, v in d.items()})


def fit_linear_model(samples: Sequence[Tuple[BatchSpec, Dict[str, float]]]
                     ) -> LinearCostModel:
    """Least-squares fit per group.  ``samples`` = (spec, group->seconds).

    On real hardware the labels come from profiling (paper step 3); in this
    repo's CPU environment they come from ``profile_synthetic`` (theoretical
    model + measured CPU perturbation) — the *fit machinery* is identical.
    """
    coef: Dict[str, np.ndarray] = {}
    for g, feat in FEATURES.items():
        X = np.stack([feat(s) for s, _ in samples])
        y = np.array([lab[g] for _, lab in samples])
        w, *_ = np.linalg.lstsq(X, y, rcond=None)
        coef[g] = np.maximum(w, 0.0)  # monotonicity (paper: preferable)
    return LinearCostModel(coef)


def group_labels_from_theory(model: TheoreticalCostModel,
                             spec: BatchSpec) -> Dict[str, float]:
    """Collapse the theoretical per-op times into the 4 fitted groups."""
    t = model.op_times(spec)
    return {
        "nonattn": t["qkv_proj"] + t["o_proj"] + t["mlp"] + t["others"]
                   + t["all_reduce"],
        "attn_prefill": t["attn_prefill"],
        "attn_decode": t["attn_decode"],
        "head": t["head"],
    }


def profile_synthetic(cfg: ModelConfig, hw: HardwareConfig, *,
                      seed: int = 0, n: int = 200,
                      noise: float = 0.03,
                      flops_eff: float = 0.6, bw_eff: float = 0.75,
                      attn_bw_eff: float = 0.25
                      ) -> List[Tuple[BatchSpec, Dict[str, float]]]:
    """Generate calibration samples over diverse (c, m, B) — paper §4.

    Labels are theoretical times de-rated by measured-style efficiency
    factors + multiplicative noise, standing in for GPU profiling runs.
    """
    rng = np.random.default_rng(seed)
    truth = TheoreticalCostModel(cfg, hw, flops_eff=flops_eff,
                                 bw_eff=bw_eff, attn_bw_eff=attn_bw_eff)
    samples = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        spec = BatchSpec()
        if kind in (0, 2):  # prefill
            b = int(rng.integers(1, 9))
            for _ in range(b):
                c = int(2 ** rng.uniform(0, 12))
                m = int(2 ** rng.uniform(0, 12)) if rng.random() < 0.5 else 0
                spec.prefills.append((c, m))
        if kind in (1, 2):  # decode
            b = int(rng.integers(1, 129))
            for _ in range(b):
                spec.decodes.append((1, int(2 ** rng.uniform(0, 13))))
        lab = group_labels_from_theory(truth, spec)
        lab = {k: v * float(rng.lognormal(0.0, noise)) for k, v in lab.items()}
        samples.append((spec, lab))
    return samples


def calibrated_cost_model(cfg: ModelConfig, hw: HardwareConfig, *,
                          seed: int = 0) -> LinearCostModel:
    """End-to-end: synthetic profile -> linear fit (the deployed model)."""
    return fit_linear_model(profile_synthetic(cfg, hw, seed=seed))
