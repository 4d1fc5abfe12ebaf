"""The port's engine serving PaliGemma-3B (``vlm``: a GELU MLP,
embeddings scaled by sqrt(d); text-only requests) against the JAX engine
on the CPU, at the reduced config in fp32: the
fixtures and tests of ``_torch_frontend_engine`` (tokens, ``BatchLog``
schedules, preemption, prefix-hit and swap counts on every plane, and
tokens equal to ``generate_reference``)."""
import torch

from _torch_frontend_engine import (  # noqa: F401  (collected here)
    models, runs, test_batch_schedule_identical_to_jax_engine,
    test_outputs_identical_to_jax_engine,
    test_preemption_prefix_and_swap_counts_identical,
    test_tokens_equal_reference)

torch.set_num_threads(2)

NAME = "paligemma-3b"
