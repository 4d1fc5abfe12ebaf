"""Internal-state invariants that survive ``python -O``.

A plain ``assert`` vanishes under ``-O``; PR 5 already converted one
such latent bug in ``PrefixCache.insert``.  Invariant guards on the
control plane (allocator tables, store byte accounting, request state
machines) are correctness checks the recovery subsystem depends on —
the chaos suite rolls state back after injected faults and then *runs*
these checks — so they must be real exceptions.

``InvariantError`` subclasses ``AssertionError`` on purpose: callers
(and the existing tests) that treat a violated invariant as an
assertion failure keep working, but the check is always armed.
"""
from __future__ import annotations


class InvariantError(AssertionError):
    """A control-plane invariant was violated (always armed, even -O)."""


def invariant(cond: object, detail: object = None) -> None:
    """Raise :class:`InvariantError` unless ``cond`` is truthy.

    ``detail`` may be any object (it is ``repr``-ed lazily into the
    message) — typically the offending state, mirroring what the old
    ``assert cond, detail`` forms carried.
    """
    if not cond:
        raise InvariantError(detail if detail is not None
                             else "invariant violated")
