"""Shared helpers of the PyTorch port's parity tests: configs, weights and
inputs are made once, from a seed, and handed to both packages (JAX
arrays and torch tensors meet only as numpy arrays)."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import model as TM


def reduced_pair(name: str = "tinyllama-1.1b", dtype: str = "float32",
                 **over):
    """The same reduced config in each package's own ModelConfig."""
    kw = dict(dtype=dtype, **over)
    return (dataclasses.replace(jax_get_config(name).reduced(), **kw),
            dataclasses.replace(torch_get_config(name).reduced(), **kw))


def params_pair(jcfg, seed: int = 0):
    """JAX init_params and the same weights as CPU torch tensors."""
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def to_torch(*arrays, dtype=None):
    out = tuple(torch.from_numpy(np.array(a)) for a in arrays)
    if dtype is not None:
        out = tuple(t.to(dtype) for t in out)
    return out if len(out) > 1 else out[0]


def np_of(x) -> np.ndarray:
    """A JAX array or torch tensor as float32 (or int) numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else a
