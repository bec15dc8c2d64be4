"""Random-Ball-Cover search: nearest representative, then exhaustive search
within that representative's bin.

Re-designs ``RBC::RBCSearch<KINECT_R, GENERIC, KINECT>`` (reference usage at
src/ICP/algorithms.cpp:3349-3371; outputs permuted queries D_OUT_Q_P, matched
NNs D_OUT_NN, and ``rbc_dist_id`` distances consumed by ICPWeights).

Queries are grouped by their assigned representative — the same trick the
reference plays (it emits *permuted* queries and runs the downstream
reductions on the permuted arrays) — which turns the per-bin exhaustive
search into one batched (n_r, cq) x (n_r, cb) search with static shapes:
no irregular control flow, no per-query neighborhood of its own size. On
the GPU the per-bin search is a Triton kernel (:mod:`icp_tpu.kernels`).

Overflow/empty-bin fallback: a query whose group slot exceeds the static
query capacity, or whose representative has an empty bin, matches the
representative's own database point (``rep_db_ids``) at the already-computed
query->representative distance. At the default capacities (database 2x
mean occupancy, query 1.5x) this hits <=~1% of queries on the worst
measured scene with registration accuracy unchanged; tests measure it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from icp_tpu.ops.distance import metric_weights, pairwise_sq_dists
from icp_tpu.rbc.construct import RBCIndex
from icp_tpu.rbc.fused_gn import bin_gn_moments, gicp_const_moment, gn_v_total
from icp_tpu.rbc.fused_point import (
    bin_min_dists,
    bin_nn,
    bin_point_moments,
    gather_slots,
    point_moments_from_P,
    prep_rep_assign,
    prep_similarity,
    rep_assign_counts,
)
from icp_tpu.rbc.grouping import group_by_bin, group_rows_by_bin


class GroupedSearchResult(NamedTuple):
    """NN results in BIN-GROUPED (permuted) query order — the layout the
    downstream reductions consume directly (they are permutation-invariant;
    the reference likewise reduces over its permuted query/NN arrays
    D_OUT_Q_P / D_OUT_NN, src/ICP/algorithms.cpp:3352-3363).

    Attributes:
      queries_g: (n_r, cq, 8) grouped queries (padded slots undefined).
      matched_g: (n_r, cq, 8) matched fixed points per slot.
      dist_g: (n_r, cq) blended squared distances.
      valid: (n_r, cq) slot validity (real query AND non-empty bin).
      n_dropped: scalar — queries not represented (capacity overflow or
        empty bin); vanishingly rare at default capacities.
      matched_normals: (n_r, cq, 3) matched fixed-surface normals (zeros
        unless the index carries normals — point-to-plane objective).
      extra_g: (n_r, cq, k) optional per-QUERY side data grouped alongside
        the queries (e.g. moving-surface normals for the symmetric plane
        objective); zeros-shaped (n_r, cq, 0) when unused.
    """

    queries_g: jnp.ndarray
    matched_g: jnp.ndarray
    dist_g: jnp.ndarray
    valid: jnp.ndarray
    n_dropped: jnp.ndarray
    matched_normals: jnp.ndarray
    extra_g: jnp.ndarray = None


def bin_phase2(bins: jnp.ndarray, bins_centered: jnp.ndarray,
               sq_b_masked: jnp.ndarray, bin_normals: jnp.ndarray | None,
               qg_w: jnp.ndarray, *, with_normals: bool):
    """Per-bin exhaustive search over grouped weighted-centered queries —
    the shared phase-2 of the single-device and mp-sharded RBC searches.

    Args:
      bins: (n_b, cb, 8) bin members (original coordinates).
      bins_centered: (n_b, cb, 8) rep-centered bin members.
      sq_b_masked: (n_b, cb) masked |b|^2 (+inf on invalid slots).
      bin_normals: (n_b, cb, 3) per-member surface normals (may be None
        when ``with_normals`` is False).
      qg_w: (n_b, cq, 8) metric-weighted rep-centered grouped queries.
    Returns:
      (best_score (n_b, cq) — +inf where the bin is empty,
       matched_g (n_b, cq, 8), matched_n (n_b, cq, 3)).
    """
    best_slot, best_score = bin_nn(qg_w, bins_centered, sq_b_masked)
    matched_g = gather_slots(bins, best_slot)
    if with_normals:
        matched_n = gather_slots(bin_normals, best_slot)
    else:
        matched_n = jnp.zeros(matched_g.shape[:2] + (3,), matched_g.dtype)
    return best_score, matched_g, matched_n


def rbc_search_grouped(index: RBCIndex, queries: jnp.ndarray, alpha,
                       query_capacity: int, with_normals: bool = False,
                       extra_rows: jnp.ndarray | None = None
                       ) -> GroupedSearchResult:
    """RBC search returning bin-grouped results (the unfused path).

    Identical search semantics to :func:`rbc_search`, but results stay in
    the grouped layout: no scatter back to original order — the consumers
    are reductions.
    """
    n_r = index.reps.shape[0]

    d2_qr = pairwise_sq_dists(queries, index.reps, alpha)
    query_rep = jnp.argmin(d2_qr, axis=1).astype(jnp.int32)

    if extra_rows is None:
        extra_rows = jnp.zeros((queries.shape[0], 0), queries.dtype)

    # One sort groups queries (and any side rows) bin-major with no
    # member table (see grouping.group_rows_by_bin).
    qlayout = group_rows_by_bin(query_rep, n_r, query_capacity,
                                (queries, extra_rows))
    queries_g, extra_g = qlayout.grouped  # (n_r, cq, 8), (n_r, cq, k)
    qc = queries_g - index.reps[:, None, :]  # per-bin centering

    w8 = metric_weights(alpha, queries.dtype)
    qg_w = qc * w8

    best_score, matched_g, matched_n = bin_phase2(
        index.bins, index.bins_centered, index.sq_b_masked,
        index.bin_normals, qg_w, with_normals=with_normals)
    # Residual from the matched row, not the cancelled score expansion.
    best_d2 = jnp.sum(w8 * (queries_g - matched_g) ** 2, axis=-1)
    valid = qlayout.valid & jnp.isfinite(best_score)
    n_dropped = queries.shape[0] - jnp.sum(valid.astype(jnp.int32))
    return GroupedSearchResult(
        queries_g=queries_g,
        matched_g=matched_g,
        dist_g=jnp.where(valid, best_d2, 0.0),
        valid=valid,
        n_dropped=n_dropped,
        matched_normals=matched_n,
        extra_g=extra_g,
    )


def rbc_point_assign_counts(index: RBCIndex, moving8: jnp.ndarray,
                            q: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray,
                            alpha):
    """Fused transform + nearest-representative assignment + per-bin
    counts (phase 1 of the fused pipeline; fused_point.rep_assign_counts).

    The counts feed the grouping, which then skips its own count. Returns
    (rid (m,), counts (n_r,), G (8, 8), b_row (1, 8)) — the similarity
    factors are returned so the search phase reuses them.
    """
    G, b_row = prep_similarity(q, t, s)
    C, srow = prep_rep_assign(index.reps, alpha, G, b_row)
    rid, counts = rep_assign_counts(moving8, C, srow)
    return rid, counts, G, b_row


def rbc_point_moments_grouped(index: RBCIndex, mg: jnp.ndarray,
                              qvalid: jnp.ndarray, G: jnp.ndarray,
                              b_row: jnp.ndarray, alpha, c, *,
                              weighted: bool, robust: str = "none",
                              robust_delta=0.0):
    """Phase 2 of the fused POINT pipeline: per-bin search + weighting +
    8x8 moment reduction over an ALREADY-grouped query table.
    """
    P = bin_point_moments(
        mg, qvalid, index.reps, index.bins_centered, index.sq_b_masked,
        G, b_row, alpha, weighted=weighted, robust=robust,
        robust_delta=robust_delta)
    return point_moments_from_P(P, index.reps, c, index.moment_w)


def rbc_min_dists_grouped(index: RBCIndex, mg: jnp.ndarray,
                          qvalid: jnp.ndarray, G: jnp.ndarray,
                          b_row: jnp.ndarray, alpha) -> jnp.ndarray:
    """Blended squared NN distance per grouped query slot (+inf invalid) —
    the adaptive-robust first pass (fused_point.bin_min_dists).
    Feed ops.moments.adaptive_robust_delta with mask = isfinite.

    Truncation note: the median sees only queries that HOLD a slot in the
    grouped layout — moving points dropped by query_capacity overflow are
    excluded (the same drop the moment reduction applies), whereas the
    unfused grouped-search path's ``adaptive_robust_delta`` sees every
    moving point. At high bin occupancy the two paths can therefore derive
    slightly different robust scales and take slightly different steps;
    both converge to the same fixed point and tests bound the drop rate
    (<~1% at default capacities).
    """
    return bin_min_dists(mg, qvalid, index.reps, index.bins_centered,
                         index.sq_b_masked, G, b_row, alpha)


def _adaptive_delta_grouped(d2: jnp.ndarray, robust: str):
    from icp_tpu.ops.moments import adaptive_robust_delta

    return adaptive_robust_delta(d2.reshape(-1),
                                 jnp.isfinite(d2).reshape(-1), robust)


def rbc_point_moments(index: RBCIndex, moving8: jnp.ndarray,
                      q: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray,
                      alpha, c, query_capacity: int, *, weighted: bool,
                      robust: str = "none", robust_delta=0.0,
                      robust_adaptive: bool = False):
    """Fused POINT-objective iteration front half: transform + rep
    assignment + grouping + per-bin search + weighting + moments. The two
    searches run as GPU kernels on the card (XLA twins elsewhere); the
    grouping sort and the moment tail are XLA.

    Args:
      index: RBC structure over the fixed set.
      moving8: (m, 8) RAW moving landmarks (the accumulated transform is
        folded into the searches).
      q, t, s: accumulated similarity.
      alpha, c: metric blend / S-matrix scaling (traced scalars).
      query_capacity: static per-bin query capacity.
      weighted: reference WEIGHTED vs REGULAR.
      robust, robust_delta: optional robust M-estimator factor on the pair
        weights (runtime.config.RobustKernel).
      robust_adaptive: derive the robust scale per call from the residual
        median via the distance-only first pass
        (:func:`rbc_min_dists_grouped`), overriding robust_delta.
    Returns:
      (S11 (11,) in the icpSijProducts layout (c applied),
       mean_f (3,), mean_m (3,), sum_w scalar).
    """
    n_r = index.reps.shape[0]
    rid, counts, G, b_row = rbc_point_assign_counts(
        index, moving8, q, t, s, alpha)
    glayout = group_rows_by_bin(rid, n_r, query_capacity, (moving8,),
                                counts=counts)
    (mg,) = glayout.grouped
    qvalid = glayout.valid.astype(moving8.dtype)
    if robust_adaptive and robust != "none":
        d2 = rbc_min_dists_grouped(index, mg, qvalid, G, b_row, alpha)
        robust_delta = _adaptive_delta_grouped(d2, robust)
    return rbc_point_moments_grouped(index, mg, qvalid, G, b_row, alpha, c,
                                     weighted=weighted, robust=robust,
                                     robust_delta=robust_delta)


def rbc_gn_system(index: RBCIndex, moving8: jnp.ndarray,
                  q: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray,
                  alpha, query_capacity: int, *, mode: str, weighted: bool,
                  robust: str = "none", robust_delta=0.0,
                  robust_adaptive: bool = False,
                  gicp_eps=0.0, mnormals_rot: jnp.ndarray | None = None
                  ) -> jnp.ndarray:
    """Fused PLANE/GICP iteration front half: transform + rep assignment +
    grouping + per-bin search + weighting + the whole GN system build,
    mirroring :func:`rbc_point_moments` for the normal-consuming
    objectives (rbc.fused_gn).

    Args:
      index: RBC structure built WITH normals (bins_vals12/gn_w present).
      moving8: (m, 8) RAW moving landmarks.
      q, t, s: accumulated similarity.
      alpha: metric blend (traced scalar).
      query_capacity: static per-bin query capacity.
      mode: "plane" | "plane_sym" | "gicp" (static).
      weighted / robust / robust_delta: residual weighting.
      gicp_eps: disk-covariance thickness (gicp mode).
      mnormals_rot: (m, 3) moving normals rotated into the fixed frame
        (required for plane_sym/gicp; grouped alongside the queries).
    Returns:
      V (8, 8) global GN moment matrix — feed
      rbc.fused_gn.gn_system_from_V then icp.plane.solve_plane_system.
    """
    assert index.bins_vals12 is not None, \
        "rbc_gn_system needs an index built with normals"
    n_r = index.reps.shape[0]
    rid, counts, G, b_row = rbc_point_assign_counts(
        index, moving8, q, t, s, alpha)
    rows = ((moving8,) if mode == "plane"
            else (moving8, mnormals_rot))
    glayout = group_rows_by_bin(rid, n_r, query_capacity, rows,
                                counts=counts)
    mg = glayout.grouped[0]
    nm = None if mode == "plane" else glayout.grouped[1]
    qvalid = glayout.valid.astype(moving8.dtype)

    if robust_adaptive and robust != "none":
        d2 = rbc_min_dists_grouped(index, mg, qvalid, G, b_row, alpha)
        robust_delta = _adaptive_delta_grouped(d2, robust)

    P = bin_gn_moments(
        mg, nm, qvalid, index.reps, index.bins_centered, index.bins_vals12,
        index.sq_b_masked, G, b_row, alpha, mode=mode, weighted=weighted,
        robust=robust, robust_delta=robust_delta, gicp_eps=gicp_eps)
    if mode == "gicp":
        # Woodbury split: the data rows' moment plus the isotropic I/2
        # block, linear in the z-moment (rbc.fused_gn.gicp_const_moment).
        P, P_z = P
        P = P + gicp_const_moment(P_z)
    return gn_v_total(P, index.reps, index.gn_w)


class SearchResult(NamedTuple):
    """NN results in ORIGINAL query order.

    Attributes:
      nn_id: (m,) database index of each query's match.
      nn_dist: (m,) blended squared distance to the match (the reference's
        ``rbc_dist_id.dist`` — feeds the weighting).
      query_rep: (m,) representative assignment per query.
      fallback: (m,) True where the overflow/empty-bin fallback was used.
    """

    nn_id: jnp.ndarray
    nn_dist: jnp.ndarray
    query_rep: jnp.ndarray
    fallback: jnp.ndarray


def rbc_search(index: RBCIndex, queries: jnp.ndarray, alpha,
               query_capacity: int) -> SearchResult:
    """Search the RBC structure for each query's in-bin nearest neighbor.

    Args:
      index: structure from :func:`icp_tpu.rbc.construct.rbc_construct`.
      queries: (m, 8) transformed moving landmarks.
      alpha: photometric blend weight (must match construction).
      query_capacity: static per-bin query capacity (ICPConfig.query_capacity).
    """
    m = queries.shape[0]
    n_r = index.reps.shape[0]

    # Phase 1: nearest representative per query — one (m, n_r) product.
    d2_qr = pairwise_sq_dists(queries, index.reps, alpha)
    query_rep = jnp.argmin(d2_qr, axis=1).astype(jnp.int32)
    d2_to_rep = jnp.min(d2_qr, axis=1)

    # Phase 2: group queries by representative (the reference's permuted
    # queries) and run every bin's exhaustive search as one batched matmul.
    # Per-bin centering on the representative: queries and bin members are
    # both near their rep, so the quadratic expansion operates on small
    # offsets and keeps full f32 accuracy (no cancellation).
    qlayout = group_by_bin(query_rep, n_r, query_capacity)
    qgroups = queries[qlayout.member] - index.reps[:, None, :]  # (n_r, cq, 8)

    w8 = metric_weights(alpha, queries.dtype)
    qg_w = qgroups * w8
    sq_q = jnp.sum(qg_w * qgroups, axis=-1)  # (n_r, cq)
    cross = jnp.einsum(
        "rqd,rcd->rqc", qg_w, index.bins_centered,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    score = index.sq_b_masked[:, None, :] - 2.0 * cross  # (n_r, cq, cb)

    best_slot = jnp.argmin(score, axis=-1)  # (n_r, cq)
    best_sc = jnp.min(score, axis=-1)
    best_d2 = jnp.where(jnp.isfinite(best_sc),
                        jnp.maximum(best_sc + sq_q, 0.0), jnp.inf)
    best_id = jnp.take_along_axis(index.bin_ids, best_slot, axis=-1)

    # Phase 3: scatter grouped results back to original query order.
    found = qlayout.valid & jnp.isfinite(best_d2)
    scatter_to = jnp.where(qlayout.valid, qlayout.member, m)  # m -> dropped

    fallback_id = index.rep_db_ids[query_rep]
    nn_id = fallback_id.at[scatter_to.reshape(-1)].set(
        jnp.where(found, best_id, fallback_id[qlayout.member]).reshape(-1),
        mode="drop",
    )
    nn_dist = d2_to_rep.at[scatter_to.reshape(-1)].set(
        jnp.where(found, best_d2, d2_to_rep[qlayout.member]).reshape(-1),
        mode="drop",
    )
    used_fallback = jnp.ones((m,), bool).at[scatter_to.reshape(-1)].set(
        jnp.logical_not(found).reshape(-1), mode="drop"
    )
    return SearchResult(nn_id, nn_dist, query_rep, used_fallback)
