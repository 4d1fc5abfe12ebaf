"""SmolLM-360M [hf:HuggingFaceTB/SmolLM] — llama-arch small, GQA kv=5."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    max_context=8192,
))
