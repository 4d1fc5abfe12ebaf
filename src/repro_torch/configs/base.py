"""Model / shape configuration system.

Every assigned architecture gets a ``ModelConfig``; the four input-shape
sets are global (``SHAPES``).  ``reduced()`` produces the CPU-smoke variant
of any config (same family, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ShapeConfig:
    """One (seq_len, global_batch) workload cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int  # query heads (0 => attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    # --- options ---
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    max_context: int = 32768
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    window: int = 0  # sliding-window attention size (0 = full attention)
    # --- modality stub frontends ---
    frontend: str = "none"  # none | patch | frames
    num_patches: int = 0  # VLM: number of image patch embeddings
    # --- numerics / padding ---
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    expert_pad_multiple: int = 16

    # ------------------------------------------------------------------ #
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 64

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim_

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def padded_experts(self) -> int:
        if not self.num_experts:
            return 0
        return pad_to(self.num_experts, self.expert_pad_multiple)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode (bounded state)."""
        return self.family in ("ssm", "hybrid")

    # ------------------------------------------------------------------ #
    def num_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.head_dim_
        p = self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            p += self.padded_vocab * d  # lm head
        per_layer = 0
        if self.family != "ssm":
            # attention
            per_layer += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            # in_proj (x,z), conv-ish mix, dt/decay projections, out_proj
            per_layer += d * 2 * di + di * self.ssm_state * 2 + di * d
            per_layer += di * 2  # gates / dt bias
        if self.num_experts:
            e = self.padded_experts
            per_layer += e * (3 * d * self.moe_d_ff) + d * e  # experts+router
            per_layer += self.num_shared_experts * 3 * d * self.moe_d_ff
        else:
            per_layer += 3 * d * self.d_ff  # gated mlp
        per_layer += 2 * d  # norms
        return p + self.num_layers * per_layer

    def active_params(self) -> int:
        """Params touched per token (MoE: only routed top-k)."""
        if not self.num_experts:
            return self.num_params()
        d = self.d_model
        dense = self.num_params() - self.num_layers * self.padded_experts * 3 * d * self.moe_d_ff
        active_moe = self.num_layers * self.experts_per_token * 3 * d * self.moe_d_ff
        return dense + active_moe

    def kv_bytes_per_token_layer(self, bytes_per_el: int = 2) -> int:
        if self.family == "ssm":
            return 0
        return 2 * self.kv_dim * bytes_per_el

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128,
            vocab_size=256,
            max_context=256,
        )
        if self.num_experts:
            kw.update(num_experts=4, experts_per_token=2, moe_d_ff=32,
                      num_shared_experts=min(self.num_shared_experts, 1),
                      expert_pad_multiple=4)
        if self.ssm_state:
            if self.family == "ssm":  # rwkv: heads*state == d_model
                kw.update(ssm_state=8, ssm_heads=8)
            else:
                kw.update(ssm_state=4, ssm_heads=4)
        if self.window:
            kw.update(window=32)
        if self.num_patches:
            kw.update(num_patches=4)
        kw.update(vocab_pad_multiple=32)
        return replace(self, **kw)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs  # noqa: F401  (ensures registration ran)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    from repro_torch import configs  # noqa: F401

    return tuple(sorted(_REGISTRY))


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Shapes runnable for this arch (long_500k only for sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return tuple(out)
