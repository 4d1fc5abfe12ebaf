"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE 128 experts top-8, GQA kv=4."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,           # per-expert ffn width
    moe_d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    num_experts=128,
    experts_per_token=8,
    num_shared_experts=0,
    max_context=32768,
))
