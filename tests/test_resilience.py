"""Failure-detection / bounded-retry tests (parallel.resilience).

The reference's failure story is try/catch + exit (SURVEY.md §5,
src/ICP/algorithms.cpp:164-168); the retry layer is an extension for
long-running service deployments. The key contract tested here:
DETERMINISTIC errors — kernel/XLA compile failures, shape
errors — surface immediately, while transient transport errors retry with
backoff.
"""

from __future__ import annotations

import pytest

from icp_tpu.parallel.resilience import (
    device_healthy,
    is_transient,
    with_retries,
)


class _FlakyFn:
    """Raises the given errors in order, then returns a value."""

    def __init__(self, errors, value=42.0):
        self.errors = list(errors)
        self.value = value
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.errors:
            raise self.errors.pop(0)
        return self.value


def test_transient_classification():
    # Transport-layer error types are transient regardless of message.
    assert is_transient(OSError("connection reset by peer"))
    assert is_transient(ConnectionResetError("peer hung up"))
    # Status-word signatures the XLA runtime actually produces.
    assert is_transient(RuntimeError("UNAVAILABLE: socket closed"))
    assert is_transient(RuntimeError("DEADLINE_EXCEEDED: 30s elapsed"))
    assert is_transient(RuntimeError("ABORTED: collective reset"))
    assert is_transient(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    # Deterministic compile/shape errors must NOT look transient.
    assert not is_transient(RuntimeError(
        "Triton failed to compile kernel: unsupported layout"))
    assert not is_transient(RuntimeError(
        "INVALID_ARGUMENT: dot dimension mismatch"))
    assert not is_transient(TypeError("unhashable type"))
    assert not is_transient(ValueError("shapes (3,) and (4,) not aligned"))


def test_deterministic_error_fails_fast():
    fn = _FlakyFn([RuntimeError("Triton failed to compile kernel")])
    with pytest.raises(RuntimeError, match="Triton"):
        with_retries(fn, retries=3, backoff_s=0.0)
    assert fn.calls == 1  # no retry burned on a compile error


def test_transient_error_retries_until_success():
    fn = _FlakyFn([RuntimeError("UNAVAILABLE: socket closed"),
                   OSError("connection reset")])
    assert with_retries(fn, retries=3, backoff_s=0.0) == 42.0
    assert fn.calls == 3


def test_transient_error_exhausts_budget():
    fn = _FlakyFn([RuntimeError("UNAVAILABLE: a")] * 4)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        with_retries(fn, retries=3, backoff_s=0.0)
    assert fn.calls == 4  # initial attempt + 3 retries


def test_custom_retry_predicate():
    fn = _FlakyFn([ValueError("flaky-by-contract")])
    out = with_retries(fn, retries=1, backoff_s=0.0,
                       retry_on=lambda e: isinstance(e, ValueError))
    assert out == 42.0 and fn.calls == 2


def test_device_healthy_smoke():
    assert device_healthy() is True
