"""Shared fixtures.  NOTE: XLA_FLAGS / device-count hacks are deliberately
NOT set here — unit tests and benches must see the real single CPU device;
multi-device tests spawn subprocesses with their own XLA_FLAGS."""
import dataclasses
import sys

import jax
import pytest

sys.path.insert(0, "src")

from repro.configs import ASSIGNED_ARCHS, get_config  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heaviest cross-plane parity tests — the tier-1 suite "
        "(plain pytest) always runs them; scripts/check.sh skips them "
        "by default (CHECK_FULL=1 opts back in)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card with nvcc (the port's CUDA kernels "
        "have no CPU mode); skips with a reason where there is none")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def reduced(name: str, dtype: str = "float32"):
    return dataclasses.replace(get_config(name).reduced(), dtype=dtype)


@pytest.fixture(scope="session", params=ASSIGNED_ARCHS)
def arch_name(request):
    return request.param
