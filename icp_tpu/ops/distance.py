"""Photogeometric 8-D distance computation.

The reference's metric (``euclideanSquaredMetric8`` from its RandomBallCover
dependency, referenced at src/ICP/algorithms.cpp:3203-3208) blends the
geometric and photometric halves of the 8-D points:

    d^2(x, x') = ||x_g - x'_g||^2 + alpha * ||x_p - x'_p||^2

where x_g = (x, y, z) is in the cloud's length unit (mm for Kinect) and
x_p = (r, g, b) in [0, 1]; alpha (default 1e2, apps 2e2) scales color
differences up to be commensurate with millimeter-scale geometry. The
homogeneous components (indices 3 and 7, both 1) cancel in differences.

Pairwise distance matrices are computed via the quadratic expansion
``d^2 = |a|^2 + |b|^2 - 2 a.b`` so the O(m*n) work is one product instead
of a broadcast-subtract (which would materialize an (m, n, 8)
intermediate in device memory).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def metric_weights(alpha, dtype=jnp.float32) -> jnp.ndarray:
    """Per-dimension weights [1,1,1,0, alpha,alpha,alpha, 0] of the metric."""
    one = jnp.ones((), dtype)
    zero = jnp.zeros((), dtype)
    a = jnp.asarray(alpha, dtype)
    return jnp.stack([one, one, one, zero, a, a, a, zero])


def pairwise_sq_dists(a: jnp.ndarray, b: jnp.ndarray, alpha) -> jnp.ndarray:
    """Blended squared distances between two 8-D point sets.

    Args:
      a: (m, 8) points.
      b: (n, 8) points.
      alpha: photometric blend weight (traced scalar ok).
    Returns:
      (m, n) float32 matrix of blended squared distances (clamped >= 0).
    """
    # Distances are invariant under a common translation; centering on b's
    # centroid shrinks |p|^2 by orders of magnitude, which directly shrinks
    # the f32 cancellation error of the quadratic expansion (coords ~2000 mm
    # would otherwise give |p|^2 ~ 4e6 and ~0.5 absolute error in d^2).
    center = jnp.mean(b, axis=0)
    a = a - center
    b = b - center
    w = metric_weights(alpha, a.dtype)
    aw = a * w  # weighted once; cross term needs w exactly once
    sq_a = jnp.sum(aw * a, axis=-1)  # sum w * a^2
    sq_b = jnp.sum((b * w) * b, axis=-1)
    # Full f32: the quadratic expansion cancels ~|p|^2-magnitude terms down
    # to ~|dp|^2, so a bf16 or TF32 product (what a float32 matmul may run
    # in by default on the GPU) would destroy the NN ordering for nearby
    # correspondences.
    cross = jnp.dot(aw, b.T, precision=jax.lax.Precision.HIGHEST)
    d2 = sq_a[:, None] + sq_b[None, :] - 2.0 * cross
    return jnp.maximum(d2, 0.0)


def dot3(a: jnp.ndarray, b: jnp.ndarray, dims) -> jnp.ndarray:
    """bf16x3 product (the classic 3-pass f32 emulation) for SCORE tensors.

    Used by the XLA twins of the GPU search kernels (which score in f32
    FMAs) and by the kNN-normals moments. Its error is ~1e-5 of the
    magnitude of the summed terms (each lo part is rounded to bf16, and
    the a_lo x b_lo term is dropped): enough for an argmin on
    rep-centered offsets, though a few near ties per registration order
    differently than in float64. A single bf16 pass would scramble the NN
    order of the cancelled quadratic expansion.

    The hi part is anchored with ``lax.reduce_precision`` rather than a
    round trip through bf16: XLA folds ``(f32)(bf16)a`` back to ``a`` when
    excess precision is allowed (its default), collapsing the three passes
    into one single-bf16 product. On an H100 the plain round trip measured
    4.7e-3 of max |p.C| against float64 on the 262144 x 2048 assignment
    scores, the anchored form 1.5e-5. reduce_precision(a, 8, 7) rounds
    exactly like ``astype(bf16)``, so nothing changes where no folding
    happens (the CPU).
    """
    a_hi_f = jax.lax.reduce_precision(a, 8, 7)
    b_hi_f = jax.lax.reduce_precision(b, 8, 7)
    a_hi = a_hi_f.astype(jnp.bfloat16)
    a_lo = (a - a_hi_f).astype(jnp.bfloat16)
    b_hi = b_hi_f.astype(jnp.bfloat16)
    b_lo = (b - b_hi_f).astype(jnp.bfloat16)

    def f(x, y):
        return jax.lax.dot_general(x, y, dims,
                                   preferred_element_type=jnp.float32)

    return f(a_hi, b_hi) + f(a_hi, b_lo) + f(a_lo, b_hi)


def point_sq_dists(a: jnp.ndarray, b: jnp.ndarray, alpha) -> jnp.ndarray:
    """Blended squared distances between aligned point pairs.

    Args:
      a, b: (n, 8) aligned sets.
    Returns:
      (n,) blended squared distances.
    """
    w = metric_weights(alpha, a.dtype)
    d = a - b
    return jnp.sum(w * d * d, axis=-1)


def nearest_neighbor_brute(queries: jnp.ndarray, database: jnp.ndarray, alpha):
    """Exact NN via the full distance matrix (reference config 1 baseline).

    Returns:
      (nn_idx (m,) int32, nn_dist (m,) squared blended distance).
    """
    d2 = pairwise_sq_dists(queries, database, alpha)
    nn_idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
    nn_dist = jnp.min(d2, axis=-1)
    return nn_idx, nn_dist
