"""Failure detection / retry for device dispatch.

The reference's failure story is try/catch + exit (SURVEY.md §5). A
long-running mapping service can see transient dispatch failures (a device
briefly out of memory, a reset collective, a lost RPC in a multi-process
run); this module provides the minimal production plumbing: health probes
and bounded-retry execution with backoff, designed to wrap whole jitted
dispatches (retrying a pure function is always safe).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Tuple, Type, TypeVar

import jax
import jax.numpy as jnp

log = logging.getLogger("icp_tpu.resilience")

T = TypeVar("T")

# Error TYPES that are transient regardless of message (transport layer).
TRANSIENT_ERRORS: Tuple[Type[BaseException], ...] = (OSError,)

# Message signatures of transient device/RPC failures. JAX surfaces both
# transient runtime faults (resource exhaustion, RPC resets) and
# DETERMINISTIC compile errors (kernel lowering, XLA InvalidArgument) as
# the same Python types (RuntimeError/XlaRuntimeError), so a bare
# type-based filter burns every retry + backoff on an error that can never
# succeed. Classify by the absl status-code words the runtime embeds
# instead.
TRANSIENT_SIGNATURES: Tuple[str, ...] = (
    "unavailable",
    "deadline exceeded",
    "deadline_exceeded",
    "resource exhausted",
    "resource_exhausted",
    "aborted",
    "cancelled",
    "connection reset",
    "connection refused",
    "socket closed",
    "broken pipe",
    "timed out",
    "timeout",
    "temporarily",
    "try again",
    "rpc failed",
    "rpc error",
)


def is_transient(e: BaseException) -> bool:
    """True when ``e`` looks like a transient device/transport failure that
    a retry can plausibly fix; False for deterministic errors (compile
    failures, shape/type errors) that must surface immediately."""
    if isinstance(e, TRANSIENT_ERRORS):
        return True
    msg = str(e).lower()
    return any(sig in msg for sig in TRANSIENT_SIGNATURES)


def device_healthy(timeout_ok: bool = True) -> bool:
    """Cheap device heartbeat: one tiny dispatch must complete."""
    try:
        x = jax.block_until_ready(jnp.ones((8,)) + 1.0)
        return bool(x.shape == (8,))
    except Exception as e:  # noqa: BLE001 — health probe must not raise
        log.warning("device heartbeat failed: %s", e)
        return False


def with_retries(fn: Callable[..., T], *args, retries: int = 3,
                 backoff_s: float = 1.0,
                 retry_on: Callable[[BaseException], bool] = is_transient,
                 **kwargs) -> T:
    """Run ``fn(*args, **kwargs)`` with bounded retries on transient device
    errors. The result is blocked-on before being considered successful, so
    async dispatch failures surface inside the guarded region.

    ``retry_on`` is a predicate over the raised exception (default
    :func:`is_transient`); deterministic errors — compile failures,
    shape/type errors — re-raise immediately instead of burning the retry
    budget with backoff on a failure that cannot heal.

    Raises the last error after ``retries`` failed attempts.
    """
    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            return jax.block_until_ready(fn(*args, **kwargs))
        except Exception as e:  # noqa: BLE001 — classified below
            if not retry_on(e):
                raise  # deterministic: fail fast, no backoff
            last = e
            if attempt == retries:
                break
            delay = backoff_s * (2.0 ** attempt)
            log.warning("dispatch failed (attempt %d/%d): %s — retrying in %.1fs",
                        attempt + 1, retries, e, delay)
            time.sleep(delay)
            device_healthy()
    assert last is not None
    raise last
