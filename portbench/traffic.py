"""The one traffic generator: turns a mix file
(``portbench/mixes/<name>.json``) and a seed into the requests of one run.

A mix is offline batch work (``"kind": "backlog"``): every request is due
at 0, and the harness keeps ``queue_depth`` of them waiting.  Sizes come in
blocks of ``block`` = ``STRATA``**2 requests that all hold the same
multiset of prompt and output lengths, drawn by stratified quantiles
(``(i + 0.5) / n`` of the mix's distribution) and laid out so that every
run of ``STRATA`` requests holds one request of each octile of the output
lengths and of the prompt lengths.  The seed draws that layout and the
token ids, so any served stretch of the backlog holds the same work for
every seed (drawn independently, the sizes moved the cells' throughput
between seeds by twice as much; PERF.md §6).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

MIX_DIR = Path(__file__).resolve().parent / "mixes"
STRATA = 8              # each run of this many requests holds every octile


@dataclass
class Req:
    rid: int
    prompt: np.ndarray          # int32 token ids
    output_len: int


def load_mix(name: str) -> Dict:
    with open(MIX_DIR / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("kind") != "backlog":
        raise ValueError(f"mix {name}: unknown kind {mix.get('kind')!r}")
    return mix


def stratified(dist: Dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the quantiles ``(i + 0.5) / n`` of ``dist``:
    ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
    ``{"dist": "uniform", "min", "max"}``, clipped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        x = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown dist {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def max_context(mix: Dict) -> int:
    """The longest prompt plus output the mix can make (its page-rounded
    value sizes the engine's per-request context)."""
    return int(mix["prompt_tokens"]["max"]) + int(mix["output_tokens"]["max"])


def shrink(mix: Dict, factor: int) -> Dict:
    """The mix with every token length divided by ``factor`` (outputs at
    least 2 tokens): the CPU tests' size."""
    out = json.loads(json.dumps(mix))
    for key in ("prompt_tokens", "output_tokens"):
        d = out[key]
        lo = 2 if key == "output_tokens" else 1
        for k in ("min", "max", "median"):
            if k in d:
                d[k] = max(lo, int(d[k]) // factor)
    return out


def make_requests(mix: Dict, seed: int, vocab: int) -> List[Req]:
    """Blocks of ``block`` requests.  Request (i, j) of a block pairs the
    i-th output-length stratum with the j-th prompt-length stratum
    (``pl[S j + i]``, ``ol[S i + j]``), and each run of ``STRATA``
    requests is one row of a Latin square: one request of every output
    stratum and of every prompt stratum.  The seed draws the square (a
    permutation), the order of the runs and the order inside each."""
    block, count, S = int(mix["block"]), int(mix["count"]), STRATA
    if block != S * S:
        raise ValueError(f"backlog block {block} != {S} x {S}")
    pl = stratified(mix["prompt_tokens"], block)
    ol = stratified(mix["output_tokens"], block)
    shuffle = _rng(seed, 0)
    toks = _rng(seed, 1)
    out = []
    for b in range(-(-count // block)):
        pi = shuffle.permutation(S)
        pairs = [(int(pl[S * ((c + pi[i]) % S) + i]),
                  int(ol[S * i + (c + pi[i]) % S]))
                 for c in shuffle.permutation(S)
                 for i in shuffle.permutation(S)]
        for j, (n, o) in enumerate(pairs):
            rid = b * block + j
            if rid >= count:
                break
            out.append(Req(rid=rid,
                           prompt=toks.integers(0, vocab, size=n,
                                                dtype=np.int32),
                           output_len=o))
    return out
