"""Per-iteration statistical reductions: weights, centroids, deviations, S.

These replace the reference's two-phase local-memory reduction kernels
(``icpComputeReduceWeights``, ``icpMean``, ``icpMean_Weighted``, ``icpGMean``,
``icpSubtractMean``, ``icpSijProducts[_Weighted]``, reference
kernels/icp_kernels.cl:138-743) with fused XLA reductions. The
cross-covariance is formulated as a (3, m) x (m, 3) product, and every
function takes an optional validity mask so the same code
serves the padded RBC path and sharded execution (where each shard reduces
its slice and the partials are ``psum``-ed — see icp_tpu.parallel).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def compute_weights(dists: jnp.ndarray) -> jnp.ndarray:
    """Correspondence weights ``w_i = 100 / (100 + d_i)``.

    ``d_i`` is the blended squared NN distance produced by the search (the
    reference feeds the ``rbc_dist_id.dist`` field straight in,
    kernels/icp_kernels.cl:158).
    """
    return 100.0 / (100.0 + dists)


def robust_factor(d2: jnp.ndarray, kind: str, delta) -> jnp.ndarray:
    """IRLS weight of a robust M-estimator on the blended squared distance.

    Beyond-reference extension (see runtime.config.RobustKernel): composes
    multiplicatively with :func:`compute_weights`. ``delta`` is in blended
    DISTANCE units (the kernel compares d^2 against delta^2). Elementwise on
    d^2 only — fuses into the hot Pallas moment kernel.

    Args:
      d2: blended squared NN distances (any shape).
      kind: static "none" | "huber" | "tukey" | "trimmed".
      delta: traced scalar scale (ICPParams.robust_delta).
    """
    if kind == "none":
        return jnp.ones_like(d2)
    delta = jnp.asarray(delta, d2.dtype)
    d2 = jnp.maximum(d2, 0.0)
    if kind == "huber":
        # w = min(1, delta/|r|); exact 1 at r = 0 (rsqrt guard).
        return jnp.minimum(
            1.0, delta * jax.lax.rsqrt(jnp.maximum(d2, jnp.asarray(1e-12, d2.dtype))))
    if kind == "tukey":
        z = jnp.maximum(1.0 - d2 / (delta * delta), 0.0)
        return z * z
    if kind == "trimmed":
        return (d2 <= delta * delta).astype(d2.dtype)
    raise ValueError(f"unknown robust kernel: {kind!r}")


def masked_median(x: jnp.ndarray, mask: Optional[jnp.ndarray]) -> jnp.ndarray:
    """Median of ``x`` over ``mask`` (one sort + one dynamic pick).

    Invalid slots sort to +inf; the pick index is (count-1)//2 (lower
    median). Returns 0 when nothing is valid.
    """
    if mask is not None:
        x = jnp.where(mask, x, jnp.inf)
    s = jnp.sort(x.reshape(-1))
    cnt = (jnp.sum(mask.astype(jnp.int32)) if mask is not None
           else jnp.asarray(x.size, jnp.int32))
    med = s[jnp.maximum(cnt - 1, 0) // 2]
    return jnp.where(cnt > 0, med, 0.0)


# Per-kernel adaptive-scale constants on median(|r|) (robust_adaptive):
# sigma_hat = 1.4826 * MAD ~ 1.4826 * median(|r|) for zero-centered
# residuals; Huber's classic c = 1.345 sigma and Tukey's c = 4.685 sigma
# give ~2 and ~7 median multiples; TRIMMED at 3x median rejects the gross
# tail while tolerating pre-convergence misalignment.
_ADAPTIVE_K = {"huber": 2.0, "tukey": 7.0, "trimmed": 3.0}


def adaptive_robust_delta(d2: jnp.ndarray, mask: Optional[jnp.ndarray],
                          kind: str) -> jnp.ndarray:
    """Per-iteration robust scale from the residuals themselves.

    delta = K_kind * sqrt(median(d2 over valid pairs)) — the median is
    unaffected by <50% contamination, and the scale anneals as the
    alignment converges. Guarded to a 1e-3 floor so a perfectly-converged
    frame (all-zero residuals) never zeroes every weight.
    """
    med_r = jnp.sqrt(jnp.maximum(masked_median(d2, mask), 0.0))
    return jnp.maximum(_ADAPTIVE_K[kind] * med_r, 1e-3)


def masked_median_sharded(x: jnp.ndarray, mask: Optional[jnp.ndarray],
                          axes, bins: int = 256) -> jnp.ndarray:
    """Global lower-median of ``x`` over ``mask`` across mesh ``axes``.

    Call inside ``shard_map``. Three scalar-class collectives instead of
    gathering the residual vectors:

      1. local lower medians bracket the global one — at least half of
         every shard's valid mass sits on each side of its local median,
         so summing over shards puts the global median inside
         ``[min_s med_s, max_s med_s]``;
      2. one ``psum`` of a ``bins``-bin histogram of the valid values over
         that (narrow) interval, plus the below-interval rank offset,
         locates the global rank k = (count-1)//2 to within
         (hi - lo) / bins — sub-percent of the local-median spread.

    The histogram is built as a one-hot reduction, not a scatter. Exact (returns the shared value) when every shard's local
    median agrees; returns 0 when no shard has a valid element.
    """
    x = x.reshape(-1)
    m = (jnp.ones(x.shape, bool) if mask is None else mask.reshape(-1))
    cnt_l = jnp.sum(m.astype(jnp.int32))
    med_l = masked_median(x, m)
    has = cnt_l > 0
    lo = jax.lax.pmin(jnp.where(has, med_l, jnp.inf), axes)
    hi = jax.lax.pmax(jnp.where(has, med_l, -jnp.inf), axes)
    total = jax.lax.psum(cnt_l, axes)

    width = jnp.maximum(hi - lo, 0.0)
    # Bin index of every valid element inside [lo, hi] (clipped; elements
    # below lo are counted separately into the rank offset).
    scale = jnp.where(width > 0, bins / width, 0.0)
    xi = jnp.clip(((x - lo) * scale).astype(jnp.int32), 0, bins - 1)
    in_interval = (m & (x >= lo)).astype(x.dtype)
    hist_l = jnp.sum(
        jax.nn.one_hot(xi, bins, dtype=x.dtype) * in_interval[:, None],
        axis=0)
    below_l = jnp.sum((m & (x < lo)).astype(jnp.int32))
    hist = jax.lax.psum(hist_l, axes)
    below = jax.lax.psum(below_l, axes)

    k = jnp.maximum(total - 1, 0) // 2  # 0-based lower-median rank
    cum = below.astype(x.dtype) + jnp.cumsum(hist)
    bin_idx = jnp.argmax(cum > k.astype(x.dtype))  # first covering bin
    est = lo + (bin_idx.astype(x.dtype) + 0.5) * (width / bins)
    est = jnp.where(width > 0, est, lo)  # all local medians agree -> exact
    return jnp.where(total > 0, est, jnp.zeros((), x.dtype))


def adaptive_robust_delta_sharded(d2: jnp.ndarray,
                                  mask: Optional[jnp.ndarray],
                                  kind: str, axes) -> jnp.ndarray:
    """Distributed :func:`adaptive_robust_delta` (inside ``shard_map``):
    the residual median comes from :func:`masked_median_sharded`, so every
    shard derives the identical global robust scale."""
    med_r = jnp.sqrt(jnp.maximum(masked_median_sharded(d2, mask, axes), 0.0))
    return jnp.maximum(_ADAPTIVE_K[kind] * med_r, 1e-3)


def masked_weight_sum(weights: jnp.ndarray,
                      mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Sum of weights (the reference promotes to f64 in ``reduce_sum_fd``;
    XLA accumulates f32 with tree reductions, which is comparably safe for
    n = 16384)."""
    if mask is not None:
        weights = jnp.where(mask, weights, 0.0)
    return jnp.sum(weights)


def centroids(fixed8: jnp.ndarray, moving8: jnp.ndarray,
              weights: Optional[jnp.ndarray] = None,
              sum_w: Optional[jnp.ndarray] = None,
              mask: Optional[jnp.ndarray] = None):
    """Fused xyz centroids of the matched fixed and moving sets.

    Regular mode mirrors ``icpMean`` (divide by n before reducing,
    kernels/icp_kernels.cl:370-411); weighted mode mirrors
    ``icpMean_Weighted`` (reduce (w_i / sum_w) * x_i,
    kernels/icp_kernels.cl:454-495).

    Args:
      fixed8: (n, 8) matched fixed points (NN results).
      moving8: (n, 8) transformed moving points.
      weights: optional (n,) weights.
      sum_w: optional precomputed sum of weights (required with weights).
      mask: optional (n,) validity mask for padded layouts.
    Returns:
      (mean_f (3,), mean_m (3,)).
    """
    f = fixed8[..., :3]
    m = moving8[..., :3]
    if weights is None:
        if mask is None:
            n = jnp.asarray(f.shape[0], f.dtype)
            return jnp.sum(f, 0) / n, jnp.sum(m, 0) / n
        valid = mask.astype(f.dtype)
        n = jnp.maximum(jnp.sum(valid), 1.0)
        return (jnp.sum(f * valid[:, None], 0) / n,
                jnp.sum(m * valid[:, None], 0) / n)
    w = weights if mask is None else jnp.where(mask, weights, 0.0)
    # Guard against a fully-masked frame (sensor dropout): 0/0 would put a
    # NaN into the state that poisons every following iteration.
    safe_w = jnp.where(sum_w > 0, sum_w, 1.0)
    wn = (w / safe_w)[:, None]
    return jnp.sum(f * wn, 0), jnp.sum(m * wn, 0)


def centroid_partials(fixed8: jnp.ndarray, moving8: jnp.ndarray,
                      weights: Optional[jnp.ndarray] = None,
                      mask: Optional[jnp.ndarray] = None):
    """Shard-local partial sums for the centroid computation.

    Returns (sum_f (3,), sum_m (3,), denom scalar) such that the global
    centroid is psum(sum) / psum(denom) — the distributed form of
    :func:`centroids` used by icp_tpu.parallel (centroid = a ``psum`` of
    per-shard partials over ICI, SURVEY.md §5 "distributed reductions").
    """
    f = fixed8[..., :3]
    m = moving8[..., :3]
    if weights is None:
        if mask is None:
            denom = jnp.asarray(f.shape[0], f.dtype)
            return jnp.sum(f, 0), jnp.sum(m, 0), denom
        valid = mask.astype(f.dtype)
        return (jnp.sum(f * valid[:, None], 0),
                jnp.sum(m * valid[:, None], 0), jnp.sum(valid))
    w = weights if mask is None else jnp.where(mask, weights, 0.0)
    return jnp.sum(f * w[:, None], 0), jnp.sum(m * w[:, None], 0), jnp.sum(w)


def deviations(points8: jnp.ndarray, mean3: jnp.ndarray) -> jnp.ndarray:
    """xyz deviations from a centroid; drops the photometric half.

    Mirrors ``icpSubtractMean`` (kernels/icp_kernels.cl:587-602).
    """
    return points8[..., :3] - mean3


def s_matrix(dev_m: jnp.ndarray, dev_f: jnp.ndarray, c,
             weights: Optional[jnp.ndarray] = None,
             mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """The 11-vector of cross-covariance sums and scale constituents.

    Matches the ``icpSijProducts[_Weighted]`` + ``reduce_sum_f`` chain
    (kernels/icp_kernels.cl:632-743):

        S11[3i+j] = sum_k w_k (c * m_dev[k, i]) (c * f_dev[k, j])
        S11[9]    = sum_k w_k |c * f_dev[k]|^2
        S11[10]   = sum_k w_k |c * m_dev[k]|^2

    The ``c`` factor (default 1e-6) guards f32 range on millimeter-scale
    data; eigenvectors are unchanged and s_k = sqrt(S9/S10) cancels it.

    The 3x3 block is one (3, m) x (m, 3) product.

    Args:
      dev_m: (n, 3) moving-set deviations.
      dev_f: (n, 3) fixed-set deviations.
      c: scaling factor (traced scalar ok).
      weights: optional (n,) weights (raw, not normalized — ref semantics).
      mask: optional (n,) validity mask.
    Returns:
      (11,) S vector.
    """
    cm = dev_m * c
    cf = dev_f * c
    if weights is not None:
        w = weights if mask is None else jnp.where(mask, weights, 0.0)
    elif mask is not None:
        w = mask.astype(cm.dtype)
    else:
        w = None

    hi = jax.lax.Precision.HIGHEST  # full f32; bf16 or TF32 would lose
    # the small cross-covariance signal of nearly-converged iterations.
    if w is None:
        S3 = jnp.dot(cm.T, cf, precision=hi)  # S3[i, j] = sum m_i f_j
        ff = jnp.sum(cf * cf)
        mm = jnp.sum(cm * cm)
    else:
        wm = cm * w[:, None]
        S3 = jnp.dot(wm.T, cf, precision=hi)
        ff = jnp.sum(w * jnp.sum(cf * cf, axis=-1))
        mm = jnp.sum(w * jnp.sum(cm * cm, axis=-1))
    return jnp.concatenate([S3.reshape(9), jnp.stack([ff, mm])])
