"""Hand-written Hopper kernels (CUDA C++ under each package's csrc/),
each beside its plain PyTorch version and a device-dispatched entry."""
