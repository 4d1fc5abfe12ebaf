"""Inference workload generators (paper §5.5, §8, App. C).

* fixed (I, O) grids — §5's controlled sweeps
* SISO/SILO/LISO/LILO heterogeneous mixes — App. C
* AzureConv-like online conversation trace — §8 (lognormal lengths,
  Poisson-ish arrivals over an hour; avg I≈1.2K max 14.1K, avg O≈0.2K
  max 1K)
* LongForm-like offline generation trace — §8 (avg I≈250 max 8.4K,
  avg O≈380 max 3.8K; uniform arrivals over 100 s)

All return ``List[Request]`` with real token ids optional (engine mode).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Request


def _mk(spec: Sequence[Tuple[int, int, float]],
        vocab: Optional[int] = None, seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    out = []
    for i, (I, O, a) in enumerate(spec):
        prompt = (rng.integers(0, vocab, size=I).tolist()
                  if vocab is not None else None)
        out.append(Request(rid=i, input_len=int(I), output_len=int(O),
                           arrival=float(a), prompt=prompt))
    return out


def fixed_grid(W: int, I: int, O: int, *, vocab: Optional[int] = None,
               seed: int = 0) -> List[Request]:
    """W identical offline requests (paper §5.5 workloads)."""
    return _mk([(I, O, 0.0)] * W, vocab=vocab, seed=seed)


GROUPS = {
    "SISO": ((8, 16), (8, 16)),
    "SILO": ((8, 16), (512, 1024)),
    "LISO": ((512, 1024), (8, 16)),
    "LILO": ((512, 1024), (512, 1024)),
}


def hetero_mix(groups: Sequence[str], W: int, *, seed: int = 0,
               vocab: Optional[int] = None) -> List[Request]:
    """Shuffled mix of two (or more) App.-C groups, offline arrivals."""
    rng = np.random.default_rng(seed)
    spec = []
    for i in range(W):
        g = GROUPS[groups[i % len(groups)]]
        I = int(rng.choice(g[0]))
        O = int(rng.choice(g[1]))
        spec.append((I, O, 0.0))
    rng.shuffle(spec)
    return _mk(spec, vocab=vocab, seed=seed + 1)


def _lognormal(rng, mean: float, maximum: float, n: int) -> np.ndarray:
    """Lognormal with the given mean, clipped at maximum (>= 1)."""
    sigma = 1.0
    mu = math.log(mean) - sigma ** 2 / 2
    x = rng.lognormal(mu, sigma, size=n)
    return np.clip(x, 1, maximum).astype(int)


def azureconv_like(n: int = 512, *, duration_s: float = 3600.0,
                   o_scale: float = 1.0, seed: int = 0,
                   vocab: Optional[int] = None) -> List[Request]:
    """Online conversation trace with AzureConv's published statistics."""
    rng = np.random.default_rng(seed)
    I = _lognormal(rng, 1200, 14_100, n)
    O = np.maximum((_lognormal(rng, 200, 1000, n) * o_scale), 1).astype(int)
    arrivals = np.sort(rng.uniform(0.0, duration_s, size=n))
    return _mk(list(zip(I, O, arrivals)), vocab=vocab, seed=seed + 1)


def longform_like(n: int = 256, *, duration_s: float = 100.0,
                  o_scale: float = 1.0, seed: int = 0,
                  vocab: Optional[int] = None) -> List[Request]:
    """Long-form generation trace (uniform arrivals in [0, 100 s])."""
    rng = np.random.default_rng(seed)
    I = _lognormal(rng, 250, 8_400, n)
    O = np.maximum((_lognormal(rng, 380, 3_800, n) * o_scale), 1).astype(int)
    arrivals = rng.uniform(0.0, duration_s, size=n)
    return _mk(list(zip(I, O, arrivals)), vocab=vocab, seed=seed + 1)


def shared_prefix(n: int = 8, *, input_len: int = 32,
                  prefix_frac: float = 0.75, num_groups: int = 1,
                  output_len: int = 8, vocab: int = 1000,
                  stagger: float = 0.0, seed: int = 0) -> List[Request]:
    """Relational-LLM-style workload: ``num_groups`` groups of requests
    whose prompts share a common leading prefix of
    ``round(prefix_frac * input_len)`` tokens (think one system prompt /
    table schema fanned out over rows), with per-request random
    suffixes.  This is the workload shared-prefix page reuse exists for:
    with ``prefix_frac=0.75`` and 8 requests, ~75% of prompt pages
    dedupe to one physical copy.  Always generates real token ids
    (engine mode).

    ``stagger`` delays every request after each group's first by that
    many seconds: the template request prefills (and publishes its
    prefix pages) one batch ahead of the fan-out, which is the shape
    real deployments have — the system prompt is in the page registry
    before the per-row queries arrive.  Prefix reuse is cross-batch:
    requests co-scheduled into the same prefill batch all miss."""
    assert 0.0 <= prefix_frac < 1.0
    rng = np.random.default_rng(seed)
    plen = int(round(prefix_frac * input_len))
    prefixes = [rng.integers(0, vocab, size=plen).tolist()
                for _ in range(num_groups)]
    out = []
    for i in range(n):
        suffix = rng.integers(0, vocab, size=input_len - plen).tolist()
        prompt = prefixes[i % num_groups] + suffix
        out.append(Request(rid=i, input_len=input_len,
                           output_len=output_len,
                           arrival=0.0 if i < num_groups else stagger,
                           prompt=prompt))
    return out


def zipf_shared_prefix(n: int = 48, *, num_groups: int = 6,
                       alpha: float = 1.2, page_size: int = 8,
                       prefix_pages: Tuple[int, int] = (2, 4),
                       input_len: int = 48, output_len: int = 4,
                       vocab: int = 1000, arrival_gap: float = 5e-4,
                       seed: int = 0) -> List[Request]:
    """Zipf-skewed hot-prefix workload — the analytics shape of
    *Optimizing LLM Queries in Relational Workloads* (arXiv 2403.05821),
    where hit-rate-blind LRU loses and cost-based replacement wins.

    ``num_groups`` prefix templates with popularity ``p(g) ∝
    (g+1)^-alpha``: a few HOT templates are re-referenced constantly, a
    long tail of COLD templates appears once or twice.  Template prefix
    LENGTH grows with coldness (``prefix_pages`` = (hot, cold) in full
    ``page_size`` pages): the cold tail is exactly the long-prefix scan
    traffic that flushes an LRU registry, while the §6 break-even policy
    evicts those first (long prefixes have SHORTER break-even residency
    — Eq. 5) and keeps the hot short templates resident.

    Prompts = group prefix + per-request random suffix padded to a
    common ``input_len``; arrivals are staggered ``arrival_gap`` apart so
    reuse is cross-batch (co-scheduled duplicates all miss).  Always
    generates real token ids (engine mode)."""
    assert num_groups >= 2 and prefix_pages[0] <= prefix_pages[1]
    assert n >= num_groups, \
        f"need n >= num_groups (every template appears once), " \
        f"got n={n} < {num_groups}"
    assert prefix_pages[1] * page_size < input_len, \
        "prefix must leave room for a suffix"
    rng = np.random.default_rng(seed)
    probs = (1.0 / np.arange(1, num_groups + 1) ** alpha)
    probs /= probs.sum()
    lo, hi = prefix_pages
    plens = [int(round(lo + (hi - lo) * g / max(num_groups - 1, 1)))
             * page_size for g in range(num_groups)]
    prefixes = [rng.integers(0, vocab, size=p).tolist() for p in plens]
    # every group appears at least once (the cold tail must exist to
    # pollute the cache); remaining draws follow the Zipf popularity
    groups = list(range(num_groups)) \
        + rng.choice(num_groups, size=n - num_groups, p=probs).tolist()
    rng.shuffle(groups)
    out = []
    for i, g in enumerate(groups):
        suffix = rng.integers(0, vocab,
                              size=input_len - plens[g]).tolist()
        out.append(Request(rid=i, input_len=input_len,
                           output_len=output_len,
                           arrival=i * arrival_gap,
                           prompt=prefixes[g] + suffix))
    return out


def conversation_tree(n: int = 24, *, page_size: int = 8,
                      system_pages: int = 3, turn_pages: int = 1,
                      branching: int = 2, depth: int = 2,
                      output_len: int = 4, vocab: int = 1000,
                      arrival_gap: float = 5e-4,
                      seed: int = 0) -> List[Request]:
    """Branching multi-turn conversations — the radix-trie workload.

    One shared system prompt (``system_pages`` full pages) roots a
    ``branching``-ary tree of conversation turns, each turn a run of
    ``turn_pages`` full pages; every request walks root -> leaf and
    appends one UNIQUE final page (its own last user message), so no
    two prompts are identical but every pair sharing a tree path shares
    that path's token prefix.  This is exactly where an all-or-nothing
    exact-match registry scores ZERO (the unique tail breaks every
    full-prompt probe) while a radix trie converts each shared path
    into a partial hit — the PR 9 exit-criterion workload.

    Requests are dealt round-robin over the ``branching**depth`` leaves
    (every leaf path occurs, hot paths first) and staggered
    ``arrival_gap`` apart so reuse is cross-batch.  Prompt length is
    uniform: ``(system_pages + depth*turn_pages + 1) * page_size``
    tokens.  Always generates real token ids (engine mode)."""
    assert page_size > 1 and system_pages >= 1 and turn_pages >= 1
    assert branching >= 2 and depth >= 1
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=system_pages * page_size).tolist()
    # turns[path] caches the token run for each tree node so siblings
    # share ancestors verbatim (trie nodes must be byte-identical)
    turns: dict = {}

    def turn(path: Tuple[int, ...]) -> List[int]:
        run = turns.get(path)
        if run is None:
            run = rng.integers(0, vocab,
                               size=turn_pages * page_size).tolist()
            turns[path] = run
        return run

    leaves = [()]
    for _ in range(depth):
        leaves = [p + (b,) for p in leaves for b in range(branching)]
    order = list(range(len(leaves)))
    rng.shuffle(order)
    input_len = (system_pages + depth * turn_pages + 1) * page_size
    out = []
    for i in range(n):
        path = leaves[order[i % len(leaves)]]
        prompt = list(system)
        for d in range(1, depth + 1):
            prompt += turn(path[:d])
        prompt += rng.integers(0, vocab, size=page_size).tolist()
        out.append(Request(rid=i, input_len=input_len,
                           output_len=output_len,
                           arrival=i * arrival_gap, prompt=prompt))
    return out
