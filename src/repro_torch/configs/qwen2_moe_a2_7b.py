"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 4 shared + 60 routed top-4.

60 routed experts are padded to 64 for 16-way expert parallelism; router
logits for the 4 padding experts are fixed at -inf (parity-tested).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    experts_per_token=4,
    num_shared_experts=4,
    max_context=8192,
))
