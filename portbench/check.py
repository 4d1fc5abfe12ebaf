"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the engine finished (drawn from the seed, the request with the
most served tokens always in it) goes through the float32 reference: each
prompt with its served tokens, as one sequence.  At every served position
the reference's logit of the served token is compared with its best logit;
the widest such gap over the sample (``max_logit_gap``) and their mean
over all served positions (``mean_logit_gap``) are the numbers compared,
each against its limit in ``portbench/limits/<cell>.json``.  Greedy
decoding makes the served token the program's own best, so a sound run's
gaps are its rounding against the reference's.

``served_gaps(..., quant="fp8")`` also computes them for the control: the
reference in fp8 (``reference.model``'s ``quant="fp8"``) picks its best
token at each of the same positions, and the float32 reference reads
that token's gap.  ``control_reading`` puts those numbers under the
program's names, so that ``verdict`` judges the control by the same
limits.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference import model as ref
from portbench.reference.adapter import PortWeights

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
SAMPLE_TOKENS = 1024     # served tokens the sample reaches at least
SAMPLE_MIN = 4           # requests at least (where as many finished)
SAMPLE_MAX = 16          # requests at most


def load_limits(cell: str) -> Dict:
    p = LIMITS_DIR / f"{cell}.json"
    return json.loads(p.read_text()) if p.exists() else {}


def sample(finished: Dict[int, Tuple[np.ndarray, List[int]]],
           seed: int) -> List[int]:
    """The longest finished request, then others in an order drawn from
    the seed, until SAMPLE_MIN requests and SAMPLE_TOKENS served tokens,
    or SAMPLE_MAX requests."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(finished[r][1]), -r))
    rest = sorted(r for r in finished if r != longest)
    np.random.default_rng([int(seed) % (1 << 63), 7]).shuffle(rest)
    out, n = [longest], len(finished[longest][1])
    for r in rest:
        if (n >= SAMPLE_TOKENS and len(out) >= SAMPLE_MIN) \
                or len(out) >= SAMPLE_MAX:
            break
        out.append(r)
        n += len(finished[r][1])
    return out


def _sequences(finished, rids, device):
    seqs, picks, served = [], [], []
    for r in rids:
        prompt, toks = finished[r]
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])
        seqs.append(torch.as_tensor(seq, dtype=torch.long, device=device))
        I = len(prompt)
        picks.append(torch.arange(I - 1, I - 1 + len(toks), device=device))
        served.append(torch.as_tensor(toks, dtype=torch.long, device=device))
    return seqs, picks, served


def served_gaps(m, params, finished, rids, device,
                quant: Optional[str] = None) -> Dict[str, float]:
    """max over the sample of (reference best - reference logit of the
    served token); with ``quant``, also the control's number: the gap of
    the token the lower-precision reference puts first."""
    if not rids:
        return {"max_logit_gap": float("nan"),
                "mean_logit_gap": float("nan"), "served_tokens": 0,
                "requests": 0}
    ref.exact_fp32()
    w = PortWeights(m, params, device=device)
    seqs, picks, served = _sequences(finished, rids, device)
    out = ref.logits_at(m, w, seqs, picks)
    res = _numbers(out, served)
    res.update(served_tokens=int(sum(len(s) for s in served)),
               requests=len(rids))
    if quant:
        low = ref.logits_at(m, w, seqs, picks, quant=quant)
        res.update({"control_" + k: v for k, v in _numbers(
            out, [lo.argmax(-1) for lo in low]).items()})
    return res


def _numbers(logits, tokens) -> Dict[str, float]:
    """The widest and the mean gap of ``tokens``' logits below the best,
    over every position of every sequence."""
    gaps = torch.cat([lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0]
                      for lg, t in zip(logits, tokens)])
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean())}


def control_reading(reading: Dict[str, float]) -> Dict[str, float]:
    """The control's numbers of ``served_gaps(..., quant=...)`` under the
    program's names, over the same served tokens."""
    out = {k[len("control_"):]: v for k, v in reading.items()
           if k.startswith("control_")}
    out.update(served_tokens=reading["served_tokens"],
               requests=reading["requests"])
    return out


def verdict(reading: Dict[str, float], limits: Dict) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): every limited number at or
    under its limit, and at least one served token judged."""
    checks = {}
    ok = reading.get("served_tokens", 0) > 0
    for name, lim in limits.get("limits", {}).items():
        v = reading.get(name, float("nan"))
        checks[name] = {"value": v, "limit": lim}
        ok = ok and (v == v) and v <= lim
    if not limits.get("limits"):
        ok = False
    return ok, checks
