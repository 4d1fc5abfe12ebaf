"""Hymba-1.5B [arXiv:2411.13676] — parallel attention + mamba heads per layer.

Sliding-window attention (2048) as in the paper's local layers; the fused
attn||SSM head structure is modeled as two parallel branches whose
normalized outputs are averaged.  Meta tokens are omitted (documented in
DESIGN.md §Arch-applicability).  vocab 32001 padded to 32256.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_heads=50,      # d_inner=3200 / head_dim 64
    ssm_expand=2,
    window=2048,
    max_context=524288,
))
