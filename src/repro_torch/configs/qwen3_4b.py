"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — qk_norm, GQA kv=8, head_dim 128."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    max_context=32768,
))
