"""Online I->O histogram for SRF+Hist (paper §8).

Buckets input lengths by log2; tracks a running mean of observed output
lengths per bucket.  ``predict`` falls back to the global mean, then to a
prior, for unseen buckets.
"""
from __future__ import annotations

import math
from typing import Dict


class OutputLengthHistogram:
    def __init__(self, prior: float = 256.0):
        self.prior = prior
        self.sum: Dict[int, float] = {}
        self.count: Dict[int, int] = {}
        self.global_sum = 0.0
        self.global_count = 0

    @staticmethod
    def _bucket(input_len: int) -> int:
        return max(0, int(math.log2(max(1, input_len))))

    def observe(self, input_len: int, output_len: int) -> None:
        b = self._bucket(input_len)
        self.sum[b] = self.sum.get(b, 0.0) + output_len
        self.count[b] = self.count.get(b, 0) + 1
        self.global_sum += output_len
        self.global_count += 1

    def predict(self, input_len: int) -> float:
        b = self._bucket(input_len)
        if self.count.get(b, 0) >= 3:
            return self.sum[b] / self.count[b]
        if self.global_count >= 3:
            return self.global_sum / self.global_count
        return self.prior
