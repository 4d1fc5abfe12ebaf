"""Operations and bytes that the work of a step needs, from its shapes.

A frozen copy of the counting rules behind ``PERF.md``'s kernel table,
applied here to each step's real rows (``serve.StepRec``) rather than to
fixed smoke shapes.  Only the work the requests need is counted: inert
rows of the padded grid, the dense MoE dispatch's unused experts and
recomputed positions count as nothing.

* B1 (paged decode, split and merge kernels), per layer and step: the
  K and V of every page the decode rows attend over, each page once
  however many rows share it, each row's q once, its output once; a row
  needs ``4 * H * D * ctx`` operations (QK^T and PV).
* B2 (paged prefill), per layer and round: the pages before the
  prefilling rows' chunks (each once), the chunks' q, k and v, the
  chunks' K/V rows written into the pool and the outputs; a query at
  position ``p`` attends to ``p + 1`` keys.
* A model step's operations (for ``mfu``): two per weight a useful token
  meets (the MoE: its ``experts_per_token`` routed experts, the shared
  expert and the router), attention's ``4 * H * D * (p + 1)`` per layer,
  and the output head for each token that emits.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> Dict[str, float]:
    table = json.loads(PEAKS_FILE.read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r}; have {sorted(table)}")
    return table[kind]


def b1_step(m, ctxs: List[int], kv_tokens: Optional[int] = None,
            el: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of ONE layer's B1 launch over decode rows with
    context lengths ``ctxs`` (the new token included).  ``kv_tokens``:
    the distinct K/V tokens the rows read (a page that rows share is read
    once); by default every row's own."""
    H, Hkv, D = m.num_heads, m.num_kv_heads, m.head_dim
    kv = sum(ctxs) if kv_tokens is None else kv_tokens
    ops = 4.0 * H * D * sum(ctxs)
    byt = el * (2.0 * Hkv * D * kv + 2.0 * H * D * len(ctxs))
    return ops, byt


def b2_round(m, rows: List[Tuple[int, int, int, bool]],
             kv_tokens: Optional[int] = None,
             el: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of ONE layer's B2 launch over the prefilling
    rows of a round, each (start, tokens, useful, emits).  ``kv_tokens``:
    the distinct K/V tokens of the pages before the rows' chunks (a page
    that rows share is read once); by default every row's own."""
    H, Hkv, D = m.num_heads, m.num_kv_heads, m.head_dim
    kv = sum(s for s, _, _, _ in rows) if kv_tokens is None else kv_tokens
    ops = byt = 0.0
    for s, n, _, _ in rows:
        ops += 4.0 * H * D * (n * s + n * (n + 1) / 2.0)
        byt += el * (2.0 * Hkv * D * n          # the chunk's k and v
                     + 2.0 * Hkv * D * n        # written into the pool
                     + 2.0 * H * D * n)         # q in, out
    return ops, byt + el * 2.0 * Hkv * D * kv   # pages before the chunks


def linear_ops_per_token(m) -> float:
    """Two operations per weight a token meets in one layer."""
    d = m.d_model
    attn = d * (m.q_dim + 2 * m.kv_dim) + m.q_dim * d
    if m.num_experts:
        mlp = (m.experts_per_token * 3 * d * m.moe_d_ff
               + 3 * d * m.shared_d_ff + d          # shared expert + gate
               + d * m.num_experts)                 # router
    else:
        mlp = 3 * d * m.d_ff
    return 2.0 * (attn + mlp)


def step_ops(m, decode_ctx: List[int],
             rounds: List[List[Tuple[int, int, int, bool]]]) -> float:
    """Useful operations of one engine step: decode tokens, the useful
    prompt positions of its prefill chunks, and the head for every token
    it emits."""
    lin = linear_ops_per_token(m) * m.num_layers
    head = 2.0 * m.d_model * m.vocab_size
    att = 4.0 * m.num_heads * m.head_dim * m.num_layers
    ops = 0.0
    for c in decode_ctx:
        ops += lin + att * c + head
    for rnd in rounds:
        for s, n, useful, emits in rnd:
            if useful:
                lo = s + n - useful
                # positions lo .. s+n-1 each attend to p + 1 keys
                ops += lin * useful + att * (useful * lo
                                             + useful * (useful + 1) / 2.0)
            if emits:
                ops += head
    return ops


def least_time(ops: float, byt: float, flops: float, bw: float) -> float:
    return max(ops / flops, byt / bw)
