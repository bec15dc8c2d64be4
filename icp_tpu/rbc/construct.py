"""Random-Ball-Cover construction over the fixed set.

Re-designs the reference's ``RBC::RBCConstruct<KINECT_R, GENERIC>`` (external
RandomBallCover dependency; usage at reference src/ICP/algorithms.cpp:
3316-3343, memory slots D_IN_X / D_IN_R / D_OUT_X_P / D_OUT_O / D_OUT_N):

  1. point -> representative blended 8-D distances,
  2. each point assigned to its nearest representative,
  3. per-representative counts and offsets (count + exclusive scan),
  4. database permuted into bin-major order.

Step 1 is one (n, 8) x (8, n_r) product (see icp_tpu.ops.distance); steps
3-4 are the fixed-capacity grouping of icp_tpu.rbc.grouping. The padded
(n_r, capacity, 8) bin tensor gives the search static shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from icp_tpu.ops.distance import pairwise_sq_dists
from icp_tpu.rbc.fused_gn import gn_translation_tensor
from icp_tpu.rbc.fused_point import point_translation_tensor
from icp_tpu.rbc.grouping import GroupedRows, group_rows_by_bin


class RBCIndex(NamedTuple):
    """The RBC data structure over the fixed set.

    Attributes:
      reps: (n_r, 8) representatives.
      rep_db_ids: (n_r,) database index nearest to each representative (== the
        representative itself when reps are sampled from the database, as the
        pipeline does — ``getReps`` samples landmarks). Used as the search's
        overflow/empty-bin fallback match.
      db: (n, 8) the original database (fixed landmarks).
      rep_id: (n,) nearest-representative assignment per database point.
      layout: fixed-capacity bin-major grouping of the database.
      bins: (n_r, capacity, 8) padded per-representative point bins.
      bin_ids: (n_r, capacity) original database index per bin slot.
      bin_mask: (n_r, capacity) slot validity.
    """

    reps: jnp.ndarray
    rep_db_ids: jnp.ndarray
    db: jnp.ndarray
    rep_id: jnp.ndarray
    layout: GroupedRows
    bins: jnp.ndarray
    bin_ids: jnp.ndarray
    bin_mask: jnp.ndarray
    bins_centered: jnp.ndarray
    sq_b_masked: jnp.ndarray
    alpha: jnp.ndarray
    normals: jnp.ndarray  # (n, 3) fixed-surface normals (zeros if unused)
    bin_normals: jnp.ndarray  # (n_r, capacity, 3)
    # (n_r, 8, 8, 18) hoisted POINT moment-translation coefficients
    # (rbc.fused_point.point_translation_tensor) — loop-invariant, so the
    # per-iteration grouped-moment tail is one matvec instead of ~20 small
    # slice/outer/sum ops.
    moment_w: jnp.ndarray
    # Fused PLANE/GICP (rbc.fused_gn) hoisted invariants, None unless
    # the index carries normals: (n_r, cb, 12) [centered points | normals]
    # matched-gather payload and the (n_r, 8, 8, 64) GN frame-translation
    # coefficients (gn_translation_tensor).
    bins_vals12: jnp.ndarray | None
    gn_w: jnp.ndarray | None


def rbc_construct(db: jnp.ndarray, reps: jnp.ndarray, alpha,
                  capacity: int,
                  rep_db_ids: jnp.ndarray | None = None,
                  normals: jnp.ndarray | None = None) -> RBCIndex:
    """Build the RBC structure.

    Args:
      db: (n, 8) fixed-set landmarks.
      reps: (n_r, 8) representatives.
      alpha: photometric blend weight of the 8-D metric.
      capacity: static per-bin capacity (ICPConfig.bin_capacity). Database
        points whose within-bin rank exceeds it are dropped from their bin
        (vanishingly rare at the default 4x mean occupancy; they remain in
        ``db``/``rep_id`` for diagnostics).
      rep_db_ids: optional (n_r,) database indices of the representatives.
        The pipeline's representatives ARE database points at statically
        known indices (getReps samples the landmark grid), so pass them and
        skip the argmin over the long axis of the distance matrix.
      normals: optional (n, 3) fixed-surface normals (for the point-to-plane
        objective); stored bin-grouped alongside the points.
    Returns:
      RBCIndex pytree.
    """
    d2 = pairwise_sq_dists(db, reps, alpha)  # (n, n_r)
    rep_id = jnp.argmin(d2, axis=1).astype(jnp.int32)
    if rep_db_ids is None:
        # Nearest database point per representative — distance-0 self-match
        # when the representative is a database point.
        rep_db_ids = jnp.argmin(d2, axis=0).astype(jnp.int32)

    with_normals = normals is not None
    if normals is None:
        normals = jnp.zeros((db.shape[0], 3), db.dtype)
    # One payload sort groups points, their database ids (exact in f32 up
    # to 2^24), and normals bin-major in a single pass — no member table,
    # no permute gather (see grouping.group_rows_by_bin).
    ids_col = jnp.arange(db.shape[0], dtype=db.dtype)[:, None]
    layout = group_rows_by_bin(rep_id, reps.shape[0], capacity,
                               (db, ids_col, normals))
    bins, ids_g, bin_normals = layout.grouped
    bin_ids = ids_g[..., 0].astype(jnp.int32)

    # Search-time invariants, hoisted out of the per-iteration search:
    # per-bin-centered bins (f32-safe quadratic expansion) and the masked
    # |b|^2 row — +inf on invalid slots doubles as the search mask, saving
    # a full (n_r, cq, cb) where-pass every iteration.
    from icp_tpu.ops.distance import metric_weights

    bins_centered = bins - reps[:, None, :]
    w8 = metric_weights(alpha, db.dtype)
    sq_b = jnp.sum((bins_centered * w8) * bins_centered, axis=-1)
    # Invalid slots AND invalid (zero-geometry Kinect) database points are
    # masked out of matching entirely — the reference's kernel docs defer
    # the invalid-point discard downstream (kernels/icp_kernels.cl:50-51);
    # excluding them from the search is that processing, done once here.
    nonzero_db = jnp.sum(jnp.abs(bins[..., :3]), axis=-1) > 0
    sq_b_masked = jnp.where(layout.valid & nonzero_db, sq_b, jnp.inf)

    return RBCIndex(
        reps=reps,
        rep_db_ids=rep_db_ids,
        db=db,
        rep_id=rep_id,
        layout=layout,
        bins=bins,
        bin_ids=bin_ids,
        bin_mask=layout.valid,
        bins_centered=bins_centered,
        sq_b_masked=sq_b_masked,
        alpha=jnp.asarray(alpha, db.dtype),
        normals=normals,
        bin_normals=bin_normals,
        moment_w=point_translation_tensor(reps),
        bins_vals12=(jnp.concatenate(
            [bins_centered, bin_normals,
             jnp.zeros(bins.shape[:2] + (1,), db.dtype)], axis=-1)
            if with_normals else None),
        gn_w=gn_translation_tensor(reps) if with_normals else None,
    )
