"""Config registry: importing this package registers the architectures
this port serves: the dense family, the mixture-of-experts family,
RWKV6 (``family="ssm"``) and the hybrid family (hymba: sliding-window
attention beside a selective SSM)."""
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
    llama2_7b,
    llama3_8b,
    qwen3_moe_30b_a3b,
    qwen2_moe_a2_7b,
    rwkv6_7b,
    hymba_1_5b,
)
