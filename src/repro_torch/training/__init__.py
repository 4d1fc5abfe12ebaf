"""Training substrate: AdamW, schedules, microbatched train step."""
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_update,
    global_norm,
    init_adamw,
    lr_at,
)
from repro_torch.training.train_step import (  # noqa: F401
    make_loss_fn,
    make_train_step,
    value_and_grad,
)
