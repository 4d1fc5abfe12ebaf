"""Top-down SLO attainment from cost models (paper §5.3, Fig. 7).

Given a TPOT/batch-time threshold, compute the pareto frontier of
(c_prefill, m_decode) combinations whose hybrid-batch time equals the
threshold — instead of bottom-up parameter sweeping.  Works with any
monotone cost model (linear or theoretical) via bisection on m.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import BatchSpec, CostModel


def hybrid_batch_time(model: CostModel, *, num_prefill: int, c: int,
                      num_decode: int, m: int, m_prefill: int = 0) -> float:
    spec = BatchSpec(
        prefills=[(c, m_prefill)] * num_prefill,
        decodes=[(1, m)] * num_decode,
    )
    return model.batch_time(spec)


def max_m_for_threshold(model: CostModel, *, num_prefill: int, c: int,
                        num_decode: int, threshold: float,
                        m_max: int = 1 << 20) -> Optional[int]:
    """Largest decode context m with batch time <= threshold (None if even
    m=0 violates it).  Bisection — valid because time is monotone in m."""
    if hybrid_batch_time(model, num_prefill=num_prefill, c=c,
                         num_decode=num_decode, m=0) > threshold:
        return None
    lo, hi = 0, m_max
    while lo < hi:
        mid = (lo + hi + 1) // 2
        t = hybrid_batch_time(model, num_prefill=num_prefill, c=c,
                              num_decode=num_decode, m=mid)
        if t <= threshold:
            lo = mid
        else:
            hi = mid - 1
    return lo


@dataclass
class ParetoPoint:
    c: int
    m: int
    batch_time: float


def pareto_curve(model: CostModel, *, num_prefill: int, num_decode: int,
                 threshold: float,
                 cs: Sequence[int] = (1, 16, 64, 256, 1024, 4096)
                 ) -> List[ParetoPoint]:
    """(c, m) combinations making the hybrid batch time == threshold
    (Fig. 7); any point under the curve satisfies TPOT < threshold."""
    out: List[ParetoPoint] = []
    for c in cs:
        m = max_m_for_threshold(model, num_prefill=num_prefill, c=c,
                                num_decode=num_decode, threshold=threshold)
        if m is None:
            continue
        t = hybrid_batch_time(model, num_prefill=num_prefill, c=c,
                              num_decode=num_decode, m=m)
        out.append(ParetoPoint(c=c, m=m, batch_time=t))
    return out


def balanced_intensity(head_dim: int, n_q: int, n_kv: int,
                       c: int) -> float:
    """§5.2: attention intensity FLOPs/RW -> 2/(1/H + ceil(c/H)·N_KV/(c·N_Q)).
    For prefill (large c) -> ~2/(2/H)=H; for decode (c=1) -> ~2/(1/H+N_KV/N_Q).
    """
    import math
    return 2.0 / (1.0 / head_dim
                  + math.ceil(c / head_dim) * n_kv / (c * n_q))
