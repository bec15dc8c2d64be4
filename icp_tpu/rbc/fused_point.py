"""The fused RBC iteration: search front, POINT moments and their assembly.

An ICP iteration in the bin-grouped layout runs in two device passes
around the grouping sort:

1. ``rep_assign_counts`` — the reference's transform kernel + RBC
   nearest-representative phase (icpTransform_Quaternion,
   kernels/icp_kernels.cl:771-802, then the RBC query->representative
   distances). The accumulated similarity, the metric weighting and the
   representative centering fold into a precomputed (8, n_r) matrix C and
   a (1, n_r) row srow (:func:`prep_rep_assign`), so the assignment is
   ``argmin(srow - 2 p @ C)``; it also returns per-bin counts for the
   grouping.

2. ``bin_nn`` — per-bin exhaustive search: each grouped query's best slot
   and score in its representative's bin. The matched row is then a plain
   gather, and the statistical tail — the reference's weights, centroids,
   deviations and S-matrix — reduces per bin to ONE 8x8 weighted
   second-moment matrix::

       u_i = [m_cx, m_cy, m_cz, 1, f_cx, f_cy, f_cz, 1]
       P_b = sum_i w_i * u_i u_i^T                       (8, 8)

   whose homogeneous lanes carry every statistic the Horn solve needs:
   sum(w) at [3,3], the weighted centroid sums in row/column 3, the 3x3
   cross-covariance block at [0:3, 4:7] and the deviation energies on the
   diagonal blocks.

Both searches run as Pallas-Triton kernels on the GPU
(:mod:`icp_tpu.kernels`), which keep their score tensors out of device
memory; elsewhere the plain-XLA twins here (``*_ref``) run, and they are
the goldens of the kernels' parity tests. The tails after the search are
XLA on every platform: they work on (n_r, cq, 8) arrays.

Moment frame: per-bin centered on the representative (both sides), which
keeps every product at offset scale (f32-safe); the caller translates the
per-bin partials back to the common frame with exact algebra over n_r rows
(:func:`point_moments_from_P` — the same translation the reference's
c-scaling trick addresses, kernels/icp_kernels.cl:609-613).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from icp_tpu.icp.quaternion import quat_to_matrix
from icp_tpu.kernels import on_gpu
from icp_tpu.kernels.bin_nn import bin_nn as bin_nn_kernel
from icp_tpu.kernels.rep_assign import rep_assign_counts as rep_assign_kernel
from icp_tpu.ops.distance import dot3, metric_weights
from icp_tpu.ops.moments import robust_factor

_HI = jax.lax.Precision.HIGHEST


def prep_similarity(q: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray):
    """Fold the accumulated similarity into row-vector form.

    Returns (G (8, 8), b_row (1, 8)) such that for 8-D row points p:

        transform_points(p, q, t, s) == p @ G + b_row

    (geometry lanes get s*R(q) p + t; the homogeneous and photometric
    lanes pass through, G being identity there and b_row zero).
    """
    R = quat_to_matrix(q)
    A = jnp.eye(8, dtype=R.dtype)
    A = jax.lax.dynamic_update_slice(A, s * R, (0, 0))
    b_row = jnp.concatenate([t, jnp.zeros((5,), t.dtype)])[None, :]
    return A.T, b_row


def prep_rep_assign(reps: jnp.ndarray, alpha, G: jnp.ndarray,
                    b_row: jnp.ndarray):
    """Fold transform + metric + centering into the rep-assignment product.

    With ctr = mean(reps), b_c = reps - ctr, w8 the metric weights and
    tp = p @ G + b_row, the blended distance satisfies (up to a
    per-query constant, irrelevant to the argmin over representatives)::

        |tp - r|^2_w  ~  srow[r] - 2 * (p @ C)[r]

    where C = G @ (w8 * b_c)^T and srow = |b_c|^2_w - 2 (b_row - ctr)
    @ (w8 * b_c)^T. Centering both sides on ctr keeps the f32
    cancellation error of the quadratic expansion at offset scale — the
    same trick ops.distance.pairwise_sq_dists plays.

    Returns (C (8, n_r), srow (1, n_r)).
    """
    w8 = metric_weights(alpha, reps.dtype)
    ctr = jnp.mean(reps, axis=0)
    b_c = reps - ctr
    B = (b_c * w8).T  # (8, n_r)
    srow = (jnp.sum(b_c * w8 * b_c, axis=1)[None, :]
            - 2.0 * jnp.dot(b_row - ctr[None, :], B, precision=_HI))
    C = jnp.dot(G, B, precision=_HI)
    return C, srow


# ---------------------------------------------------------------------------
# Phase 1: transform + nearest representative (+ per-bin counts)
# ---------------------------------------------------------------------------


def rep_assign_counts_ref(moving8: jnp.ndarray, C: jnp.ndarray,
                          srow: jnp.ndarray):
    """Plain-XLA twin of :func:`icp_tpu.kernels.rep_assign.
    rep_assign_counts`: (rid (m,), counts (n_r,)) int32."""
    scores = srow - 2.0 * dot3(moving8, C, (((1,), (0,)), ((), ())))
    rid = jnp.argmin(scores, axis=1).astype(jnp.int32)
    return rid, jnp.bincount(rid, length=C.shape[1]).astype(jnp.int32)


def rep_assign_counts(moving8: jnp.ndarray, C: jnp.ndarray,
                      srow: jnp.ndarray):
    """Nearest representative + per-bin counts: the Triton kernel on the
    GPU, the XLA twin elsewhere. ``counts[b] == sum(rid == b)`` exactly,
    so the grouping can skip its own count."""
    return on_gpu("rep_assign", rep_assign_kernel, rep_assign_counts_ref,
                  moving8, C, srow)


# ---------------------------------------------------------------------------
# Phase 2: per-bin search
# ---------------------------------------------------------------------------


def bin_nn_ref(qg_w: jnp.ndarray, bins_c: jnp.ndarray,
               sq_b_masked: jnp.ndarray):
    """Plain-XLA twin of :func:`icp_tpu.kernels.bin_nn.bin_nn`:
    (best_slot (n_r, cq) int32, best_score (n_r, cq)).

    Per query the argmin only needs |b|^2 - 2 q.b (|q|^2 is a row
    constant), and sq_b_masked carries +inf on invalid slots. argmin and
    min lower to one fused variadic reduce over the (n_r, cq, cb) scores.
    """
    cross = dot3(qg_w, bins_c, (((2,), (2,)), ((0,), (0,))))
    scores = sq_b_masked[:, None, :] - 2.0 * cross
    return (jnp.argmin(scores, axis=-1).astype(jnp.int32),
            jnp.min(scores, axis=-1))


def bin_nn(qg_w: jnp.ndarray, bins_c: jnp.ndarray,
           sq_b_masked: jnp.ndarray):
    """Per-bin nearest neighbour: the Triton kernel on the GPU, the XLA
    twin elsewhere."""
    return on_gpu("bin_nn", bin_nn_kernel, bin_nn_ref, qg_w, bins_c,
                  sq_b_masked)


def gather_slots(table: jnp.ndarray, slot: jnp.ndarray) -> jnp.ndarray:
    """(n_r, cb, d) table rows at (n_r, cq) slots -> (n_r, cq, d)."""
    return jnp.take_along_axis(table, slot[..., None], axis=1)


def _search_front(p, qvalid, reps, G, b_row, alpha):
    """Transform + per-bin rep centering + metric weighting + validity.

    Shapes: p (n_b, cq, 8) RAW grouped rows, qvalid (n_b, cq), reps
    (n_b, 8), G (8, 8), b_row (1, 8). Returns (qc (n_b, cq, 8) transformed
    rep-centered queries, qg_w metric-weighted qc, valid (n_b, cq) f32:
    slot occupied AND original point non-zero
    — the reference defers the invalid-point discard downstream of its
    samplers, kernels/icp_kernels.cl:50-51, and this is that discard).
    """
    tp = jnp.einsum("bqi,ij->bqj", p, G, precision=_HI)
    qc = tp + (b_row - reps)[:, None, :]  # homogeneous lanes become 0
    qg_w = qc * metric_weights(alpha, p.dtype)
    vo = (jnp.sum(jnp.abs(p[..., :3]), axis=-1) > 0).astype(p.dtype)
    return qc, qg_w, qvalid * vo


def _search_core(p, qvalid, reps, bins_c, sq_b, table, G, b_row, alpha,
                 weighted: bool, robust: str, delta):
    """Search front + :func:`bin_nn` + matched-row gather + the composed
    residual weight (reference icpComputeReduceWeights x optional robust
    IRLS factor).

    ``table`` (n_b, cb, >=8) is the gather payload whose lanes 0:8 are
    ``bins_c``. The residual d2 is taken from the gathered row, not from
    the search score: the score's quadratic expansion cancels |q|^2-sized
    terms, while the direct difference is exact to f32 rounding, so the
    weights do not depend on how precisely the search scored.

    Returns (qc (n_b, cq, 8) transformed rep-centered queries, matched
    (n_b, cq, d) gathered table rows, w (n_b, cq) validity-folded weights:
    0 on invalid slots and empty bins).
    """
    qc, qg_w, valid0 = _search_front(p, qvalid, reps, G, b_row, alpha)
    best_slot, best_score = bin_nn(qg_w, bins_c, sq_b)
    matched = gather_slots(table, best_slot)
    valid = valid0 * jnp.isfinite(best_score).astype(p.dtype)
    w = valid
    if weighted or robust != "none":
        diff = qc - matched[..., :8]
        d2 = jnp.sum(diff * diff * metric_weights(alpha, p.dtype), axis=-1)
    if weighted:
        w = w * (100.0 / (100.0 + d2))  # reference icpComputeReduceWeights
    if robust != "none":
        w = w * robust_factor(d2, robust, delta)
    return qc, matched, w


def bin_point_moments(mg: jnp.ndarray, qvalid: jnp.ndarray,
                      reps: jnp.ndarray, bins_c: jnp.ndarray,
                      sq_b_masked: jnp.ndarray, G: jnp.ndarray,
                      b_row: jnp.ndarray, alpha, *, weighted: bool,
                      robust: str = "none", robust_delta=0.0) -> jnp.ndarray:
    """Per-bin search + weighting + 8x8 moment reduction.

    Args:
      mg: (n_r, cq, 8) bin-grouped RAW moving rows.
      qvalid: (n_r, cq) f32 slot validity from the grouping.
      reps: (n_r, 8) representatives (per-bin centering).
      bins_c: (n_r, cb, 8) rep-centered bin points (RBCIndex.bins_centered).
      sq_b_masked: (n_r, cb) masked |b|^2 (+inf on invalid slots).
      G, b_row: from :func:`prep_similarity`.
      alpha: photometric blend (traced scalar).
      weighted: reference WEIGHTED vs REGULAR residual weighting.
      robust: static robust-kernel name ("none"/"huber"/"tukey"/"trimmed").
      robust_delta: traced robust scale (blended distance units).
    Returns:
      (n_r, 8, 8) per-bin weighted second-moment matrices P_b in the
      rep-centered frame (see the module docstring for the lane layout).
    """
    dt = mg.dtype
    qc, matched, w = _search_core(
        mg, qvalid, reps, bins_c, sq_b_masked, bins_c, G, b_row,
        jnp.asarray(alpha, dt), weighted, robust,
        jnp.asarray(robust_delta, dt))
    one = jnp.ones(qc.shape[:2] + (1,), dt)
    u = jnp.concatenate([qc[..., :3], one, matched[..., :3], one], axis=-1)
    # The reference's statistical tail (weights sum, icpMean[_Weighted],
    # icpSubtractMean, icpSijProducts) as one batched product.
    return jnp.einsum("bqi,bqj->bij", u * w[..., None], u, precision=_HI)


def bin_min_dists(mg: jnp.ndarray, qvalid: jnp.ndarray, reps: jnp.ndarray,
                  bins_c: jnp.ndarray, sq_b_masked: jnp.ndarray,
                  G: jnp.ndarray, b_row: jnp.ndarray, alpha) -> jnp.ndarray:
    """(n_r, cq) blended squared NN distance per grouped query slot, +inf
    on invalid slots (unoccupied, zero-geometry original, empty bin) —
    the adaptive-robust first pass. Feed ops.moments.adaptive_robust_delta
    with mask = isfinite."""
    alpha = jnp.asarray(alpha, mg.dtype)
    qc, qg_w, valid0 = _search_front(mg, qvalid, reps, G, b_row, alpha)
    best_slot, best_score = bin_nn(qg_w, bins_c, sq_b_masked)
    diff = qc - gather_slots(bins_c, best_slot)
    d2 = jnp.sum(diff * diff * metric_weights(alpha, mg.dtype), axis=-1)
    ok = jnp.logical_and(valid0 > 0, jnp.isfinite(best_score))
    return jnp.where(ok, d2, jnp.inf)


# ---------------------------------------------------------------------------
# Assembly: per-bin P matrices -> global Horn inputs
# ---------------------------------------------------------------------------


def point_moment_partials(P: jnp.ndarray, reps: jnp.ndarray,
                          W_t: jnp.ndarray | None = None) -> jnp.ndarray:
    """Translate per-bin rep-centered moments to common-frame global sums.

    Exact algebra over n_r rows (for each bin with rep r, weights w and
    m/f the TRANSFORMED-moving / matched-fixed points)::

        sum w m f^T |_bin = smf + sm r^T + r sf^T + s0 r r^T

    Args:
      P: (n_b, 8, 8) per-bin moments.
      reps: (n_b, 8) the bins' representatives.
      W_t: optional (n_b, 8, 8, 18) hoisted translation tensor
        (:func:`point_translation_tensor`). The translation is LINEAR in P
        with coefficients depending only on the loop-invariant reps, so
        with W_t the whole tail is one (1, n_b*64) x (n_b*64, 18) product
        instead of ~20 small slice/outer/sum ops.
    Returns:
      (18,) vector [W, Sm(3), Sf(3), Smf(9), Sff, Smm] of PRE-mean-
      subtraction sums — additive across disjoint bin sets, so shards
      ``psum`` this vector (the entire per-iteration POINT collective
      payload) before :func:`assemble_point_moments`.
    """
    if W_t is not None:
        n_b = P.shape[0]
        return jax.lax.dot_general(
            P.reshape(1, n_b * 64), W_t.reshape(n_b * 64, 18),
            (((1,), (0,)), ((), ())), precision=_HI).reshape(18)
    r = reps[:, :3]
    s0 = P[:, 3, 3]
    sm = P[:, 0:3, 3]
    sf = P[:, 3, 4:7]
    smf = P[:, 0:3, 4:7]
    smm = P[:, 0, 0] + P[:, 1, 1] + P[:, 2, 2]
    sff = P[:, 4, 4] + P[:, 5, 5] + P[:, 6, 6]

    W = jnp.sum(s0)
    Sm = jnp.sum(sm + s0[:, None] * r, axis=0)
    Sf = jnp.sum(sf + s0[:, None] * r, axis=0)
    Smf = jnp.sum(
        smf
        + sm[:, :, None] * r[:, None, :]
        + r[:, :, None] * sf[:, None, :]
        + s0[:, None, None] * (r[:, :, None] * r[:, None, :]),
        axis=0,
    )
    r2 = jnp.sum(r * r, axis=1)
    Sff = jnp.sum(sff + 2.0 * jnp.sum(sf * r, axis=1) + s0 * r2)
    Smm = jnp.sum(smm + 2.0 * jnp.sum(sm * r, axis=1) + s0 * r2)
    return jnp.concatenate([
        jnp.stack([W]), Sm, Sf, Smf.reshape(9), jnp.stack([Sff, Smm])])


def point_translation_tensor(reps: jnp.ndarray) -> jnp.ndarray:
    """Hoisted coefficients of the per-bin moment translation.

    :func:`point_moment_partials` is linear in P (every term carries
    exactly one P factor) with coefficients built from the bins'
    representatives — which are LOOP-INVARIANT. This returns the
    (n_b, 8, 8, 18) tensor W_t with ``sums[k] = sum_{b,i,j} P[b,i,j] *
    W_t[b,i,j,k]``, computed ONCE at index-build time.

    Built with ``jacrev`` of the direct algebra, so the two forms cannot
    drift apart. Leading axis is n_b so mp shards slice it like the other
    per-bin index fields (parallel.sharded._slice_index_for_mp).
    """
    jac = jax.jacrev(lambda P: point_moment_partials(P, reps))(
        jnp.zeros((reps.shape[0], 8, 8), reps.dtype))  # (18, n_b, 8, 8)
    return jnp.transpose(jac, (1, 2, 3, 0))


def assemble_point_moments(sums: jnp.ndarray, c):
    """Global Horn inputs from the (18,) moment sums.

    Subtracts the rank-one mean term, matching ops.moments.centroids +
    deviations + s_matrix (the reference's icpMean_Weighted /
    icpSubtractMean / icpSijProducts chain, kernels/icp_kernels.cl:454-
    743). The c scaling is applied at the end (reference
    kernels/icp_kernels.cl:609-613; it cancels in s_k).

    Returns:
      (S11 (11,) in icpSijProducts layout, mean_f (3,), mean_m (3,),
       sum_w scalar).
    """
    W = sums[0]
    Sm = sums[1:4]
    Sf = sums[4:7]
    Smf = sums[7:16].reshape(3, 3)
    Sff = sums[16]
    Smm = sums[17]

    # Fully-masked-frame guard: 0/0 here would poison the state (the solve
    # side is guarded in horn.solve_step_transform).
    safe_w = jnp.where(W > 0, W, 1.0)
    mean_m = Sm / safe_w
    mean_f = Sf / safe_w
    S3 = Smf - jnp.outer(Sm, Sf) / safe_w
    ff = Sff - jnp.sum(Sf * Sf) / safe_w
    mm = Smm - jnp.sum(Sm * Sm) / safe_w

    c2 = jnp.asarray(c, S3.dtype) ** 2
    S11 = jnp.concatenate([S3.reshape(9), jnp.stack([ff, mm])]) * c2
    return S11, mean_f, mean_m, W


def point_moments_from_P(P: jnp.ndarray, reps: jnp.ndarray, c,
                         W_t: jnp.ndarray | None = None):
    """Single-device composition: per-bin P matrices -> Horn inputs."""
    return assemble_point_moments(point_moment_partials(P, reps, W_t), c)
