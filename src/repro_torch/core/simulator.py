"""Per-batch logs and the §5.1 metrics of a served run.

Only ``BatchLog`` and ``SimResult`` of ``repro.core.simulator`` are part
of this port: the engine reports through them.  The simulation loop
(``simulate``), the ``PrefixTierSim`` prefix-tier shadow and the fault
mirror come with the simulator-parity slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.request import Request


@dataclass
class BatchLog:
    t_start: float
    t_end: float
    num_prefill: int
    num_decode: int
    tokens: int
    kv_used: int
    preempted: int
    swapped_out: int = 0        # victims suspended to host this batch
    swapped_in: int = 0         # suspended requests restored this batch
    swap_s: float = 0.0         # host-link time charged (in + out)
    wall_s: float = 0.0         # measured wall time (engine only; the
    #                             simulator advances virtual time and
    #                             leaves this 0)
    pages_used: int = 0         # physical pages live in the pool after
    #                             this batch (paged engine only; counts
    #                             shared pages once — the dedup signal)


@dataclass
class SimResult:
    requests: List[Request]
    batches: List[BatchLog] = field(default_factory=list)
    num_preemptions: int = 0    # full + partial (page-level) preemptions
    num_partial_preempts: int = 0
    num_swaps: int = 0
    # prefix-cache tier counters when a PrefixTierSim shadow ran
    # (promotions/demotions/charges + the shadow allocator's stats)
    prefix_stats: Dict[str, float] = field(default_factory=dict)
    # fault-mirror counters when SchedulerConfig.faults was set
    # (rollbacks, integrity failures, degraded recomputes, permanent
    # store failures, transient retries/backoff, swap fallbacks)
    recovery_stats: Dict[str, float] = field(default_factory=dict)

    # --- aggregate metrics (§5.1) -------------------------------------- #
    @property
    def makespan(self) -> float:
        return max((b.t_end for b in self.batches), default=0.0)

    @property
    def latency(self) -> float:
        """End-to-end latency: time until the LAST request finishes."""
        return max((r.finish_time or 0.0) for r in self.requests)

    @property
    def mean_latency(self) -> float:
        ls = [r.latency() for r in self.requests if r.latency() is not None]
        return sum(ls) / len(ls) if ls else 0.0

    @property
    def mean_ttft(self) -> float:
        ts = [r.ttft() for r in self.requests if r.ttft() is not None]
        return sum(ts) / len(ts) if ts else 0.0

    @property
    def max_ttft(self) -> float:
        ts = [r.ttft() for r in self.requests if r.ttft() is not None]
        return max(ts) if ts else 0.0

    @property
    def mean_tpot(self) -> float:
        ts = [r.tpot() for r in self.requests if r.tpot() is not None]
        return sum(ts) / len(ts) if ts else 0.0

    @property
    def tps(self) -> float:
        tok = sum(r.generated for r in self.requests)
        return tok / self.makespan if self.makespan else 0.0

    @property
    def mean_batch_size(self) -> float:
        bs = [b.num_prefill + b.num_decode for b in self.batches]
        return sum(bs) / len(bs) if bs else 0.0

    @property
    def mean_kv_used(self) -> float:
        ks = [b.kv_used for b in self.batches]
        return sum(ks) / len(ks) if ks else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "latency": self.latency,
            "mean_latency": self.mean_latency,
            "mean_ttft": self.mean_ttft,
            "max_ttft": self.max_ttft,
            "mean_tpot": self.mean_tpot,
            "tps": self.tps,
            "preemptions": float(self.num_preemptions),
            "swaps": float(self.num_swaps),
            "batches": float(len(self.batches)),
            "mean_batch_size": self.mean_batch_size,
            "mean_kv_used": self.mean_kv_used,
        }
