"""Distributed layer of the port: so far the fault-tolerance primitives
and the single-device decode-attention partials (``collectives``); the
mesh, sharding and the sharded collectives wait for ROADMAP A13."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    StragglerEvent,
    StragglerMonitor,
    run_with_retries,
)
