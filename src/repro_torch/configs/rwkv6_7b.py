"""RWKV6-7B "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay.

Per-layer time-mix with matrix-valued recurrent state (heads x D x D) and
channel-mix FFN; constant-size state => long_500k decode applies.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    ssm_state=64,         # head_dim of WKV state
    ssm_heads=64,         # 4096 / 64
    ssm_expand=1,
    max_context=524288,
))
