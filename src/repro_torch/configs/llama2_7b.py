"""Llama-2-7B — the paper's own analysis model (S=4096, Figures 4-13)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    max_context=4096,
))
