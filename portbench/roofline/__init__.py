"""The yardstick: peaks of the card and the operations and bytes of the
kernels and of a model step, applied to each step's real shapes."""
