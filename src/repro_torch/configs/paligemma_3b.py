"""PaliGemma-3B [arXiv:2407.07726] — SigLIP + gemma backbone (MQA kv=1).

The SigLIP vision tower is a STUB per assignment: ``input_specs()``
provides 256 precomputed patch embeddings of width d_model which are
concatenated in front of the text tokens during prefill.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    frontend="patch",
    num_patches=256,
    max_context=8192,
))
