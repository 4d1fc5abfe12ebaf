"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

The EnCodec frontend is a STUB: ``input_specs()`` provides token ids in
the 2048-entry codebook (flattened delay-pattern stream) plus optional
precomputed conditioning frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="frames",
    max_context=32768,
))
