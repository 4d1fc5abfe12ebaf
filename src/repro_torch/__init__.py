"""PyTorch/CUDA port of ``repro``: the paged serving path on Hopper.

Mirrors ``repro``'s layout module for module.  It imports ``torch`` and
never ``jax`` nor anything of ``repro``: the pure-Python control plane
(configs, scheduler, allocator, radix trie, cost model) is kept as its
own copy under ``configs/`` and ``core/``.  Entry points take an
explicit ``device`` and default to ``"cuda"``; the CPU runs the plain
PyTorch versions of the kernels only when the caller passes CPU tensors.
"""
