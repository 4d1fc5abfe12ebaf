"""Random weights for a cell, made from ``--seed`` on the device in the
type they are served in, in the port's parameter layout (the nested dict of
``repro_torch.models.model``: per-layer leaves stacked on a leading ``L``
axis, weights ``(in, out)``, zero-centred norm scales).

All leaves are views of ONE flat buffer filled by a few large ``normal_``
calls of a ``torch.Generator`` on the device, then scaled leaf by leaf.
The same tensors go to the engine and, cast to float32 layer by layer, to
the reference.  Nothing here imports the port.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.spec import ModelShape

#: elements filled per ``normal_`` call (keeps each call's indexing 32-bit)
FILL_CHUNK = 1 << 30
#: every leaf starts at a multiple of this many elements (16-byte aligned)
ALIGN = 64
NORM_STD = 0.1


def leaf_specs(m: ModelShape) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                           float]]:
    """(path, shape, std) of every leaf of the port's parameter tree."""
    L, d, V = m.num_layers, m.d_model, m.padded_vocab
    q, kv, D = m.q_dim, m.kv_dim, m.head_dim
    out = [(("embed",), (V, d), d ** -0.5),
           (("ln_f",), (d,), NORM_STD),
           (("layers", "ln1"), (L, d), NORM_STD),
           (("layers", "ln2"), (L, d), NORM_STD),
           (("layers", "attn", "wq"), (L, d, q), d ** -0.5),
           (("layers", "attn", "wk"), (L, d, kv), d ** -0.5),
           (("layers", "attn", "wv"), (L, d, kv), d ** -0.5),
           (("layers", "attn", "wo"), (L, q, d), q ** -0.5)]
    if m.qk_norm:
        out += [(("layers", "attn", "q_norm"), (L, D), NORM_STD),
                (("layers", "attn", "k_norm"), (L, D), NORM_STD)]
    if m.num_experts:
        E, f, fs = m.padded_experts, m.moe_d_ff, m.shared_d_ff
        out += [(("layers", "moe", "router"), (L, d, E), d ** -0.5),
                (("layers", "moe", "wi_gate"), (L, E, d, f), d ** -0.5),
                (("layers", "moe", "wi_up"), (L, E, d, f), d ** -0.5),
                (("layers", "moe", "wo"), (L, E, f, d), f ** -0.5)]
        if fs:
            out += [(("layers", "moe", "shared", "wi_gate"), (L, d, fs),
                     d ** -0.5),
                    (("layers", "moe", "shared", "wi_up"), (L, d, fs),
                     d ** -0.5),
                    (("layers", "moe", "shared", "wo"), (L, fs, d),
                     fs ** -0.5),
                    (("layers", "moe", "shared_gate"), (L, d, 1), d ** -0.5)]
    else:
        f = m.d_ff
        out += [(("layers", "mlp", "wi_gate"), (L, d, f), d ** -0.5),
                (("layers", "mlp", "wi_up"), (L, d, f), d ** -0.5),
                (("layers", "mlp", "wo"), (L, f, d), f ** -0.5)]
    if not m.tie_embeddings:
        out.append((("head",), (V, d), d ** -0.5))
    return out


def make_params(m: ModelShape, seed: int, device: str,
                dtype: torch.dtype) -> Dict:
    specs = leaf_specs(m)
    offs, total = [], 0
    for _, shape, _ in specs:
        offs.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for a in range(0, total, FILL_CHUNK):
        buf[a:a + FILL_CHUNK].normal_(generator=gen)
    params: Dict = {}
    for (path, shape, std), off in zip(specs, offs):
        leaf = buf[off:off + math.prod(shape)].view(shape)
        leaf.mul_(std)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return params
