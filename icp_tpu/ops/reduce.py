"""Row-wise reductions — parity API for the reference's generic ``Reduce``.

The reference implements two-phase local-memory tree reductions
(``reduce_min_f``, ``reduce_max_ui``, ``reduce_sum_f``/``reduce_sum_fd``,
reference kernels/reduce_kernels.cl:67-264, class ``Reduce<MIN/MAX/SUM, T>``
src/ICP/algorithms.cpp:53-330). Under XLA a row reduce is a single fused
reduction; these wrappers keep the reference's operation surface (and its
f32 -> f64 promotion variant) available to callers and tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def reduce_min(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Row-wise minimum (reference ``Reduce<MIN, float>``)."""
    return jnp.min(x, axis=axis)


def reduce_max(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Row-wise maximum (reference ``Reduce<MAX, uint>``)."""
    return jnp.max(x, axis=axis)


def reduce_sum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Row-wise sum (reference ``Reduce<SUM, float>`` — the workhorse behind
    the S-matrix reduction)."""
    return jnp.sum(x, axis=axis)


def reduce_sum_fd(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Row-wise sum with the reference's extended-precision accumulation.

    Mirrors ``reduce_sum_fd`` (float in, double out;
    kernels/icp_kernels.cl:294-329). Where f64 is available (x64-enabled
    CPU backends) this IS the reference's double accumulation. On backends
    without f64 (x64 disabled) the astype would silently truncate back to
    f32 (and warn); instead the sum runs as a Neumaier-compensated accumulation in
    the input dtype — the compensation term carries the low-order bits a
    plain f32 tree reduce drops, which is the property the reference buys
    with the double (a weight sum over 16k near-equal terms keeps ~2x the
    mantissa). Output dtype follows the backend (f64 with x64, else input
    dtype), as before.
    """
    if jax.dtypes.canonicalize_dtype(jnp.float64) == jnp.float64:
        return jnp.sum(x.astype(jnp.promote_types(x.dtype, jnp.float64)),
                       axis=axis)
    return _neumaier_sum(x, axis)


def _neumaier_sum(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Compensated (Neumaier/Kahan-Babuska) sum along ``axis``.

    Vectorized across every other dimension and across ``lanes`` parallel
    compensated accumulators; the scan walks n/lanes steps. The lane
    partials (few, well-conditioned) combine with one last compensated
    pass in plain numpy-style order.
    """
    x = jnp.moveaxis(x, axis, 0)
    n = x.shape[0]
    lanes = min(n, 128)
    pad = (-n) % lanes
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    xr = x.reshape(-1, lanes, *x.shape[1:])  # (steps, lanes, ...)

    def step(carry, v):
        s, c = carry
        t = s + v
        # Whichever addend was smaller lost its low bits; recover them.
        c = c + jnp.where(jnp.abs(s) >= jnp.abs(v),
                          (s - t) + v, (v - t) + s)
        return (t, c), None

    zeros = jnp.zeros(xr.shape[1:], x.dtype)
    (s, c), _ = jax.lax.scan(step, (zeros, zeros), xr)

    # Fold the lane partials (and their compensations) sequentially with
    # the same two-sum update — `lanes` is small, so this unrolls cheaply.
    total = s[0]
    comp = c[0]
    for i in range(1, s.shape[0]):
        t = total + s[i]
        comp = comp + jnp.where(jnp.abs(total) >= jnp.abs(s[i]),
                                (total - t) + s[i], (s[i] - t) + total)
        comp = comp + c[i]
        total = t
    return total + comp
