"""Row-wise prefix scans — parity API for the reference's generic ``Scan``.

The reference uses a 3-kernel Blelloch scheme (``inclusiveScan_i`` /
``exclusiveScan_i`` / ``addGroupSums_i``, reference
kernels/scan_kernels.cl:66-310, class ``Scan<INCL/EXCL, int>``
src/ICP/algorithms.cpp:336-615). XLA lowers ``cumsum`` to an efficient
parallel scan; the exclusive variant shifts in the identity like the
reference's shift-by-one pre-sweep.
"""

from __future__ import annotations

import jax.numpy as jnp


def inclusive_scan(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Row-wise inclusive prefix sum (reference ``Scan<INCLUSIVE>``)."""
    return jnp.cumsum(x, axis=axis)


def exclusive_scan(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Row-wise exclusive prefix sum (reference ``Scan<EXCLUSIVE>``)."""
    inc = jnp.cumsum(x, axis=axis)
    zero = jnp.zeros_like(jnp.take(inc, jnp.array([0]), axis=axis))
    shifted = jnp.concatenate(
        [zero, jnp.take(inc, jnp.arange(x.shape[axis] - 1), axis=axis)], axis=axis
    )
    return shifted
