"""One ICP iteration — the reference's ``ICPStep<CR, CW>::run`` as a single
traced function.

The reference wires nine kernel launches per iteration and round-trips
8-19 floats through the host every iteration for the rotation solve and the
T write-back (src/ICP/algorithms.cpp:3460-3501 EIGEN, 4269-4296 POWER — the
"DEVICE->HOST SYNC" in SURVEY.md §3.1). Here the entire iteration — including
the rotation solve — is device-resident XLA, so iterations chain inside a
``lax.while_loop`` with zero host traffic.

Dataflow per iteration (both variants):

    transform(moving, acc) -> NN search -> [weights] -> centroids
    -> deviations -> S matrix -> rotation solve -> accumulate
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

from icp_tpu.icp.horn import solve_step_transform
from icp_tpu.icp.plane import solve_point_to_plane
from icp_tpu.icp.quaternion import qmul, qnormalize, qrotate, transform_points
from icp_tpu.icp.state import ICPState
from icp_tpu.ops.distance import nearest_neighbor_brute
from icp_tpu.ops.moments import (
    adaptive_robust_delta,
    centroids,
    compute_weights,
    deviations,
    masked_weight_sum,
    robust_factor,
    s_matrix,
)
from icp_tpu.rbc.construct import RBCIndex
from icp_tpu.rbc.fused_gn import gn_system_from_V
from icp_tpu.rbc.search import rbc_point_moments, rbc_search_grouped
from icp_tpu.runtime.config import (
    Correspondence,
    ICPConfig,
    ICPParams,
    Objective,
    RotationMode,
    Weighting,
)


class BruteTarget(NamedTuple):
    """Light target for brute-force modes that need per-point side data
    (normals for PLANE) without the full RBC structure."""

    db: jnp.ndarray  # (n, 8) fixed landmarks
    normals: jnp.ndarray  # (n, 3) fixed-surface normals


def _find_correspondences(tm: jnp.ndarray, target: Union[RBCIndex, jnp.ndarray],
                          params: ICPParams, config: ICPConfig,
                          extra_rows: jnp.ndarray | None = None):
    """NN search: (moving (n, 8), matched_fixed (n, 8), nn_dist (n,), mask,
    matched_normals (n, 3), extra (n, k) — per-query side data carried
    through the grouping, e.g. moving normals for the symmetric objective).

    RBC mode returns everything in the bin-grouped (permuted) layout with a
    validity mask — the reductions are permutation-invariant, so nothing is
    scattered back (the reference likewise reduces over its permuted arrays,
    src/ICP/algorithms.cpp:3352-3363). Brute mode returns original order
    with mask=None.
    """
    want_normals = config.needs_normals
    if config.correspondence is Correspondence.RBC:
        assert isinstance(target, RBCIndex), "RBC mode needs an RBCIndex"
        res = rbc_search_grouped(target, tm, params.alpha,
                                 config.query_capacity,
                                 with_normals=want_normals,
                                 extra_rows=extra_rows)
        n_rows = res.queries_g.shape[0] * res.queries_g.shape[1]
        flat = lambda x: x.reshape((n_rows,) + x.shape[2:])
        return (flat(res.queries_g), flat(res.matched_g), flat(res.dist_g),
                flat(res.valid), flat(res.matched_normals),
                flat(res.extra_g))
    db = target.db if hasattr(target, "db") else target
    nn_idx, nn_dist = nearest_neighbor_brute(tm, db, params.alpha)
    if want_normals:
        assert hasattr(target, "normals"), \
            "normal-consuming objectives need a target carrying normals"
        nrm = target.normals[nn_idx]
    else:
        nrm = jnp.zeros((tm.shape[0], 3), tm.dtype)
    extra = (extra_rows if extra_rows is not None
             else jnp.zeros((tm.shape[0], 0), tm.dtype))
    return tm, db[nn_idx], nn_dist, None, nrm, extra


def icp_step(state: ICPState, moving8: jnp.ndarray,
             target: Union[RBCIndex, jnp.ndarray],
             params: ICPParams, config: ICPConfig,
             moving_normals: jnp.ndarray | None = None) -> ICPState:
    """Run one ICP iteration and return the updated state.

    Args:
      state: accumulated transform state.
      moving8: (m, 8) ORIGINAL moving landmarks (the accumulated transform is
        re-applied from scratch each iteration, exactly like the reference's
        transform kernel reading D_IN_M with the accumulated T).
      target: RBCIndex (RBC mode) or (n, 8) fixed landmarks (brute mode).
      params: dynamic scalars.
      config: static configuration.
      moving_normals: optional (m, 3) precomputed moving-cloud normals (the
        symmetric-plane / GICP side channel). They are loop-invariant —
        loop callers hoist the estimation and pass them here; None
        recomputes in-step (direct single-step callers).
    """
    # Fast path (the production POINT pipeline): transform + rep assignment
    # + grouping + per-bin search + weighting + the full statistical tail,
    # reduced to per-bin 8x8 moment matrices (icp_tpu.rbc.fused_point; the
    # two searches are GPU kernels on the card).
    if (config.fused_point
            and config.correspondence is Correspondence.RBC
            and config.objective is Objective.POINT):
        assert isinstance(target, RBCIndex)
        S11, mean_f, mean_m, _sum_w = rbc_point_moments(
            target, moving8, state.q, state.t, state.s,
            params.alpha, params.c, config.query_capacity,
            weighted=config.weighting is Weighting.WEIGHTED,
            robust=config.robust.value,
            robust_delta=params.robust_delta,
            robust_adaptive=config.robust_adaptive)
        qk, tk, sk = solve_step_transform(
            S11, mean_f, mean_m, mode=config.rotation.value,
            estimate_scale=config.estimate_scale)
        q = qnormalize(qmul(qk, state.q))
        t = sk * qrotate(qk, state.t) + tk
        s = sk * state.s
        return ICPState(q=q, t=t, s=s, qk=qk, tk=tk, sk=sk, k=state.k + 1)

    # Fast path for the normal-consuming objectives: same two-pass fused
    # pipeline as POINT, with the whole Gauss-Newton system built as
    # per-bin 8x8 moments (rbc/fused_gn.py). Adaptive robust scale (which
    # needs the per-pair residual median BEFORE the weighting) rides a
    # distance-only extra pass (rbc_min_dists_grouped).
    if (config.fused_gn
            and config.correspondence is Correspondence.RBC
            and config.objective in (Objective.PLANE, Objective.GICP)):
        from icp_tpu.icp.plane import (
            CHARACTERISTIC_LENGTH_MM,
            solve_plane_system,
        )
        from icp_tpu.rbc.search import rbc_gn_system

        assert isinstance(target, RBCIndex)
        if config.objective is Objective.GICP:
            mode = "gicp"
        elif config.plane_symmetric:
            mode = "plane_sym"
        else:
            mode = "plane"
        if mode != "plane":
            if moving_normals is None:
                from icp_tpu.ops.normals import normals_for

                moving_normals = normals_for(moving8, config.normal_mode)
            mnormals_rot = qrotate(state.q, moving_normals)
        else:
            mnormals_rot = None
        V = rbc_gn_system(
            target, moving8, state.q, state.t, state.s, params.alpha,
            config.query_capacity, mode=mode,
            weighted=config.weighting is Weighting.WEIGHTED,
            robust=config.robust.value,
            robust_delta=params.robust_delta,
            robust_adaptive=config.robust_adaptive,
            gicp_eps=params.gicp_epsilon, mnormals_rot=mnormals_rot)
        H, b = gn_system_from_V(V, CHARACTERISTIC_LENGTH_MM)
        qk, tk = solve_plane_system(H, b)
        sk = jnp.ones((), moving8.dtype)
        q = qnormalize(qmul(qk, state.q))
        t = sk * qrotate(qk, state.t) + tk
        s = sk * state.s
        return ICPState(q=q, t=t, s=s, qk=qk, tk=tk, sk=sk, k=state.k + 1)

    # 1. Transform the moving set by the accumulated similarity.
    tm = transform_points(moving8, state.q, state.t, state.s)

    # Validity of each MOVING landmark, from the ORIGINAL coordinates: an
    # invalid (zero-depth) point transformed by the accumulated state sits
    # at exactly t, not 0, so checking transformed geometry only works on
    # the first iteration. The flag rides in the query vector's lane 7 (the
    # photometric homogeneous slot, metric weight 0 — free transport through
    # every grouping/gather, no separate (m, 1) array to group).
    mv_valid = (jnp.sum(jnp.abs(moving8[..., :3]), axis=-1) > 0).astype(
        moving8.dtype)
    tm = tm.at[:, 7].set(mv_valid)

    # 2. Correspondence search (grouped layout + mask in RBC mode). The
    # symmetric plane objective and GICP thread the moving cloud's rotated
    # normals through the grouping as per-query side data.
    if ((config.objective is Objective.PLANE and config.plane_symmetric)
            or config.objective is Objective.GICP):
        if moving_normals is None:
            from icp_tpu.ops.normals import normals_for

            moving_normals = normals_for(moving8, config.normal_mode)
        extra_rows = qrotate(state.q, moving_normals)
    else:
        extra_rows = None
    mv, matched_f, nn_dist, mask, matched_n, extra = _find_correspondences(
        tm, target, params, config, extra_rows=extra_rows)

    # Discard invalid (zero-geometry) points: the reference's samplers pass
    # them through and its kernel docs defer the discard downstream
    # ("Further processing is needed for those points to be discarded",
    # kernels/icp_kernels.cl:50-51) — this is that processing. Moving-side
    # validity is read back from query lane 7 (set from ORIGINAL
    # coordinates above); the fixed/matched side is untransformed, so its
    # zero check is sound (and RBC construct already excludes invalid
    # database points from the bins).
    pair_valid = jnp.logical_and(
        mv[..., 7] > 0.5,
        jnp.sum(jnp.abs(matched_f[..., :3]), axis=-1) > 0,
    )
    mask = pair_valid if mask is None else jnp.logical_and(mask, pair_valid)

    # 3. Optional residual weighting (reference icpComputeReduceWeights),
    # composed with the optional robust M-estimator factor (beyond-reference;
    # runtime.config.RobustKernel).
    robust = config.robust.value
    if config.weighting is Weighting.WEIGHTED or robust != "none":
        w = (compute_weights(nn_dist)
             if config.weighting is Weighting.WEIGHTED
             else jnp.ones_like(nn_dist))
        if robust != "none":
            delta = (adaptive_robust_delta(nn_dist, mask, robust)
                     if config.robust_adaptive else params.robust_delta)
            w = w * robust_factor(nn_dist, robust, delta)
        if mask is not None:
            w = jnp.where(mask, w, 0.0)
        sum_w = masked_weight_sum(w)
    else:
        w, sum_w = None, None

    if config.objective is Objective.PLANE:
        # Point-to-plane Gauss-Newton step (beyond-reference accuracy mode).
        if config.plane_symmetric:
            # Symmetric objective: constrain along the averaged fixed+moving
            # normal (zero moving normals self-mask to the one-sided case).
            matched_n = matched_n + extra[..., :3]
        qk, tk = solve_point_to_plane(mv[..., :3], matched_f[..., :3],
                                      matched_n, w, mask)
        sk = jnp.ones((), mv.dtype)
    elif config.objective is Objective.GICP:
        # Plane-to-plane Mahalanobis GN step; moving normals (rotated into
        # the fixed frame) arrive through the extra-rows side channel.
        from icp_tpu.icp.gicp import solve_gicp

        qk, tk = solve_gicp(mv[..., :3], matched_f[..., :3], matched_n,
                            extra[..., :3], params.gicp_epsilon, w, mask)
        sk = jnp.ones((), mv.dtype)
    else:
        # 4-5. Centroids and deviations.
        mean_f, mean_m = centroids(matched_f, mv, w, sum_w, mask)
        dev_f = deviations(matched_f, mean_f)
        dev_m = deviations(mv, mean_m)

        # 6. Cross-covariance + scale constituents, then the rotation solve.
        S11 = s_matrix(dev_m, dev_f, params.c, w, mask)
        qk, tk, sk = solve_step_transform(
            S11, mean_f, mean_m,
            mode=config.rotation.value,
            estimate_scale=config.estimate_scale,
        )

    # 7. Accumulate (reference cpp:3491-3494):
    #    R = R_k R;  t = s_k R_k t + t_k;  s = s_k s.
    q = qnormalize(qmul(qk, state.q))
    t = sk * qrotate(qk, state.t) + tk
    s = sk * state.s
    return ICPState(q=q, t=t, s=s, qk=qk, tk=tk, sk=sk, k=state.k + 1)
