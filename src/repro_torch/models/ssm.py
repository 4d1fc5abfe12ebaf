"""The part of ``repro.models.ssm`` that the port runs so far: the chunk
size of the chunked recurrences (RWKV6's WKV6 scan).  The selective-SSM
branch of the hybrid family (``apply_ssm_full``/``apply_ssm_decode``)
waits for ROADMAP A8."""
from __future__ import annotations


def pick_chunk(S: int, pref: int) -> int:
    """Largest power-of-two divisor of S that is <= pref (>= 1)."""
    if S <= pref:  # repro: allow-recompile-hazard(S and pref are static Python ints from .shape; chunk picking is trace-time shape arithmetic)
        return S
    q = pref
    while q > 1 and S % q != 0:  # repro: allow-recompile-hazard(same trace-time shape arithmetic as above)
        q //= 2
    return max(q, 1)
