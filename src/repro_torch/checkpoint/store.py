"""Checkpoint store (npz + json manifest) for trees of torch tensors: the
port's copy of ``repro.checkpoint.store``, with its on-disk layout::

    <dir>/step_000123/
        manifest.json       # per-leaf shape/dtype, content hash
        leaves.npz          # flat leaf arrays
        COMMITTED           # written LAST (atomic-rename commit marker)

Leaf names are those the JAX store writes (its
``_flatten_with_names``): dict keys in sorted order, NamedTuple fields
as ``.field`` and list or tuple items by index, joined by ``/``.  bfloat16 leaves are stored as a
``uint16`` view with ``"bfloat16"`` in the manifest, so the port and the
JAX package read each other's checkpoints, and neither ``ml_dtypes`` nor
JAX is needed here.  Restore maps leaves into a template tree and puts
each on its template leaf's device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
LEAVES = "leaves.npz"
COMMITTED = "COMMITTED"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_names(tree: Any, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    """[(name, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out.extend(flatten_with_names(sub, f"{prefix}/{key}" if prefix
                                      else key))
    return out


def unflatten_like(template: Any, leaves: Dict[str, Any],
                   prefix: str = "") -> Any:
    """``template``'s structure with each leaf replaced by ``leaves``'s."""
    def name(key):
        return f"{prefix}/{key}" if prefix else key
    if isinstance(template, dict):
        return {k: unflatten_like(v, leaves, name(str(k)))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(unflatten_like(getattr(template, f),
                                               leaves, name(f".{f}"))
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_like(x, leaves, name(str(i)))
                              for i, x in enumerate(template))
    return leaves[prefix]


def _to_storable(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host numpy array npz can hold, and the leaf's logical dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_storable(a: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if str(a.dtype) != logical_dtype:
        raise ValueError(f"stored {a.dtype} for a {logical_dtype} leaf")
    return torch.from_numpy(a)


def save(tree: Any, directory: str, step: int) -> str:
    """Write a committed checkpoint; returns its path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    stored: Dict[str, np.ndarray] = {}
    logical: Dict[str, str] = {}
    for name, leaf in flatten_with_names(tree):
        stored[name], logical[name] = _to_storable(leaf)
    np.savez(os.path.join(tmp, LEAVES), **stored)
    digest = hashlib.sha256()
    for name in sorted(stored):
        digest.update(name.encode())
        digest.update(stored[name].tobytes())
    manifest = {
        "step": step,
        "leaves": {name: {"shape": list(a.shape), "dtype": logical[name]}
                   for name, a in stored.items()},
        "hash": digest.hexdigest(),
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    with open(os.path.join(tmp, COMMITTED), "w") as f:
        f.write("ok\n")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, COMMITTED))


def verify(path: str) -> bool:
    """Recompute the manifest hash (detects torn/corrupt checkpoints)."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, LEAVES)) as z:
            digest = hashlib.sha256()
            for name in sorted(z.files):
                digest.update(name.encode())
                digest.update(z[name].tobytes())
        return digest.hexdigest() == manifest["hash"]
    except Exception:  # torn zip, bad CRC, missing files, bad json, ...
        return False


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and is_committed(
                os.path.join(directory, name)):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def restore(template: Any, directory: str, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Load the latest (or given) committed step into ``template``'s
    structure; each leaf goes to the device of its template leaf (CPU
    where the template leaf is not a tensor)."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves: Dict[str, torch.Tensor] = {}
    with np.load(os.path.join(path, LEAVES)) as z:
        for name, tmpl in flatten_with_names(template):
            t = _from_storable(z[name], manifest["leaves"][name]["dtype"])
            if isinstance(tmpl, torch.Tensor):
                t = t.to(tmpl.device)
            leaves[name] = t
    return unflatten_like(template, leaves), step


def retain(directory: str, keep: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
