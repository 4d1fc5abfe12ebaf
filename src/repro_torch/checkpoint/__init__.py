"""Checkpointing: npz store + async manager with auto-resume."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.store import (  # noqa: F401
    list_steps,
    restore,
    retain,
    save,
    verify,
)
