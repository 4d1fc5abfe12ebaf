"""Config registry: importing this package registers all architectures."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_config,
    list_configs,
    pad_to,
)
from repro_torch.configs import (  # noqa: F401
    starcoder2_3b,
    smollm_360m,
    tinyllama_1_1b,
    qwen3_4b,
    qwen3_moe_30b_a3b,
    qwen2_moe_a2_7b,
    hymba_1_5b,
    paligemma_3b,
    rwkv6_7b,
    musicgen_medium,
    llama2_7b,
    llama3_8b,
)

ASSIGNED_ARCHS = (
    "starcoder2-3b",
    "smollm-360m",
    "tinyllama-1.1b",
    "qwen3-4b",
    "qwen3-moe-30b-a3b",
    "qwen2-moe-a2.7b",
    "hymba-1.5b",
    "paligemma-3b",
    "rwkv6-7b",
    "musicgen-medium",
)
