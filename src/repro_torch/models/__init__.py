from repro_torch.models.model import (  # noqa: F401
    decode_step,
    init_cache,
    init_params,
    params_from_jax,
    prefill,
    train_loss,
)
