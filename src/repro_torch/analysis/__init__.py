"""The port's static analysis: graph-capture hazards, host syncs,
unpriced resource mutations, config mirroring, step-transaction
coverage, counter parity, the async swap protocol and rank-local host
decisions, plus (optionally) an audit of the captured step graphs.  Run
as ``python -m repro_torch.analysis``.  See
``src/repro_torch/analysis/README.md``.
"""
from repro_torch.analysis.findings import Finding  # noqa: F401
from repro_torch.analysis.runner import ALL_RULES, run_paths  # noqa: F401
