"""Timing / profiling harness.

The reference ships a bespoke dual-path profiler: ``CPUTimer``, ``GPUTimer``
(CL-event timestamps), and ``ProfilingInfo<N>`` aggregation/printing from its
CLUtils dependency, threaded through templated ``run(GPUTimer&)`` overloads
on every class (include/ICP/algorithms.hpp:140-163, SURVEY.md §5).

The equivalents here:
  * :class:`CPUTimer` — wall-clock span timer.
  * :func:`device_time` — accurate on-device timing of a jitted callable via
    ``block_until_ready`` with warmup and min-of-N.
  * :func:`marginal_time` — dispatch-overhead-free per-unit cost via
    differencing two workload sizes (the method bench.py uses).
  * :class:`ProfilingInfo` — named-phase aggregation with the reference's
    summary-print flavor.
  * :func:`trace` — context manager around ``jax.profiler`` for deep dives.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import jax


class CPUTimer:
    """Wall-clock span timer (reference ``clutils::CPUTimer``)."""

    def __init__(self):
        self._t0 = 0.0
        self.span_ms = 0.0

    def start(self) -> "CPUTimer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.span_ms = (time.perf_counter() - self._t0) * 1e3
        return self.span_ms

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def device_time(fn: Callable, *args, reps: int = 10, warmup: int = 1) -> float:
    """Best-of-N wall time (ms) of ``fn(*args)`` including one
    block_until_ready sync (reference GPUTimer role)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def marginal_time(fn_of_n: Callable[[int], Callable], n_hi: int, n_lo: int,
                  *args, reps: int = 5) -> float:
    """Per-unit marginal cost (ms) via workload differencing — removes the
    constant dispatch cost, which dominates small workloads)."""
    t_hi = device_time(fn_of_n(n_hi), *args, reps=reps)
    t_lo = device_time(fn_of_n(n_lo), *args, reps=reps)
    return (t_hi - t_lo) / (n_hi - n_lo)


@dataclass
class ProfilingInfo:
    """Named-phase latency aggregation (reference ``ProfilingInfo<N>``)."""

    label: str = "profile"
    phases: Dict[str, List[float]] = field(default_factory=dict)

    def record(self, phase: str, ms: float) -> None:
        self.phases.setdefault(phase, []).append(ms)

    @contextlib.contextmanager
    def span(self, phase: str):
        t = CPUTimer().start()
        try:
            yield
        finally:
            self.record(phase, t.stop())

    def total(self, phase: str) -> float:
        return sum(self.phases.get(phase, []))

    def mean(self, phase: str) -> float:
        xs = self.phases.get(phase, [])
        return sum(xs) / len(xs) if xs else 0.0

    def summary(self) -> str:
        lines = [f"=== {self.label} ==="]
        grand = 0.0
        for phase, xs in self.phases.items():
            tot = sum(xs)
            grand += tot
            lines.append(
                f"  {phase:28s} n={len(xs):4d}  mean={tot/len(xs):9.3f} ms"
                f"  total={tot:9.2f} ms"
            )
        lines.append(f"  {'TOTAL':28s} {'':10s} total={grand:9.2f} ms")
        return "\n".join(lines)

    def print(self) -> None:  # noqa: A003 - mirrors reference naming
        print(self.summary())


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/icp_tpu_trace"):
    """Capture a jax.profiler trace of the enclosed block (open with
    TensorBoard or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
