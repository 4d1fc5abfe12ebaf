"""Hand-written Hopper kernels (CUDA C++ under each package's csrc/),
each beside its plain PyTorch version and a device-dispatched entry."""


class NoBackwardError(Exception):
    """A gradient was asked of a forward-only kernel (one whose TPU kernel
    has no backward in the JAX package either).  Not a ``RuntimeError``,
    so ``run_with_retries`` does not retry it."""
