"""Sharded ICP execution over a (dp, mp) device mesh.

No reference counterpart exists (the reference is strictly single-device);
this is the BASELINE.json extension: the moving/query axis is sharded over
``dp`` and the RBC representative/bin axis over ``mp``. Per iteration:

  * transform: local (embarrassingly parallel over dp).
  * phase-1 rep assignment: each mp shard scores its representative slice
    for the dp-local queries, then a min-with-payload combine (two ``pmin``
    collectives over m_local floats) resolves the global nearest
    representative — no (mp, m_local) all_gather.
  * phase-2 bin search + reductions: the OWNER shard groups its queries
    into its local bins (one payload sort) and reduces the objective
    partials directly in the bin-grouped layout — the same scatter-free
    discipline as the single-chip path (the reference likewise reduces
    over its permuted arrays, src/ICP/algorithms.cpp:3352-3363). Nothing
    is scattered back to original query order, and matched pairs never
    leave the owner shard.
  * collectives per iteration: the two phase-1 pmins plus ONE ``psum`` of
    the partial sums — 18 floats for POINT (rbc/fused_point.py moment
    partials), 27 floats (6x6 system + rhs) for PLANE/GICP.
    ``robust_adaptive`` adds the 3-collective distributed residual median
    (ops.moments.masked_median_sharded: local-median pmin/pmax bracket +
    one 256-float histogram psum).
  * rotation solve: replicated (identical tiny computation on every shard;
    cheaper than communicating it).

The whole iterate-to-convergence loop stays a ``lax.while_loop`` inside one
``shard_map``, so a multi-chip registration is still ONE dispatch.

Dropped-query semantics match the single-chip grouped/fused paths: a query
overflowing its bin's static capacity (or owning an empty bin) is masked
out of the reductions for that iteration — identical to
rbc.search.rbc_search_grouped / rbc_point_moments.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from icp_tpu.icp.horn import solve_step_transform
from icp_tpu.icp.quaternion import qmul, qnormalize, qrotate, transform_points
from icp_tpu.icp.state import ICPState, identity_state
from icp_tpu.icp.run import converged
from icp_tpu.ops.distance import metric_weights, pairwise_sq_dists
from icp_tpu.ops.moments import (
    adaptive_robust_delta_sharded,
    centroid_partials,
    compute_weights,
    deviations,
    robust_factor,
    s_matrix,
)
from icp_tpu.ops.sampling import sample_representative_indices
from icp_tpu.parallel.mesh import DP_AXIS, MP_AXIS
from icp_tpu.rbc.construct import RBCIndex, rbc_construct
from icp_tpu.rbc.fused_point import (
    assemble_point_moments,
    bin_point_moments,
    point_moment_partials,
    prep_similarity,
)
from icp_tpu.rbc.grouping import group_rows_by_bin
from icp_tpu.rbc.search import bin_phase2
from icp_tpu.runtime.config import (
    Correspondence,
    ICPConfig,
    ICPParams,
    Objective,
    Weighting,
)

# Plain int (NOT a jnp scalar: materializing one at import time would
# initialize the XLA backend before jax.distributed.initialize()).
_BIG_ID = 2 ** 30


def _slice_index_for_mp(index: RBCIndex, n_r_local: int) -> RBCIndex:
    """Slice the mp-local representative range out of a replicated index.

    Construction is replicated (it is one small matmul + sort); each mp shard
    then keeps only its slice of reps/bins. ``db`` stays replicated (the
    fixed landmark set is ~512 KB — far cheaper to copy than to shuffle
    matched points between shards every iteration).
    """
    mp_idx = jax.lax.axis_index(MP_AXIS)
    start = mp_idx * n_r_local

    def sl(x):
        return jax.lax.dynamic_slice_in_dim(x, start, n_r_local, axis=0)

    return RBCIndex(
        reps=sl(index.reps),
        rep_db_ids=sl(index.rep_db_ids),
        db=index.db,
        rep_id=index.rep_id,
        layout=index.layout,
        bins=sl(index.bins),
        bin_ids=sl(index.bin_ids),
        bin_mask=sl(index.bin_mask),
        bins_centered=sl(index.bins_centered),
        sq_b_masked=sl(index.sq_b_masked),
        alpha=index.alpha,
        normals=index.normals,
        bin_normals=sl(index.bin_normals),
        moment_w=sl(index.moment_w),
        bins_vals12=(None if index.bins_vals12 is None
                     else sl(index.bins_vals12)),
        gn_w=None if index.gn_w is None else sl(index.gn_w),
    )


def _phase1_owned_bins(local: RBCIndex, tm: jnp.ndarray, params: ICPParams,
                       n_r_local: int):
    """Global nearest representative via a min-with-payload combine.

    Each mp shard scores its local rep slice for the dp-local transformed
    queries; two ``pmin`` collectives (distance, then winner id with the
    loser shards masked to a big sentinel) resolve the global argmin —
    m_local floats each, vs the (mp, m_local) all_gather this replaces.

    Returns (bin_of_query (m_local,) int32 in [0, n_r_local] where
    n_r_local is the parking bin for queries owned by other shards).
    """
    rep_offset = jax.lax.axis_index(MP_AXIS) * n_r_local
    d2_qr = pairwise_sq_dists(tm, local.reps, params.alpha)
    best_local = jnp.argmin(d2_qr, axis=1).astype(jnp.int32)
    d_local = jnp.min(d2_qr, axis=1)
    d_min = jax.lax.pmin(d_local, MP_AXIS)
    # The owner computed d_min bitwise-exactly (pmin returns one of the
    # inputs); cross-shard ties deterministically go to the lowest rep id.
    rid = jax.lax.pmin(
        jnp.where(d_local <= d_min, best_local + rep_offset, _BIG_ID),
        MP_AXIS)
    local_rep = rid - rep_offset
    owned = (local_rep >= 0) & (local_rep < n_r_local)
    return jnp.where(owned, local_rep, n_r_local).astype(jnp.int32)


def _point_partials(local: RBCIndex, moving_local: jnp.ndarray,
                    state: ICPState, params: ICPParams, config: ICPConfig,
                    bin_of_query: jnp.ndarray, n_r_local: int,
                    query_capacity: int) -> jnp.ndarray:
    """dp/mp-local POINT moment partials in the bin-grouped layout.

    Groups the shard's owned RAW moving rows into its local bins (overflow
    and remote-owned queries land in the dropped parking bin) and reduces
    straight to per-bin 8x8 moment matrices — the single-device fused
    pipeline (rbc/fused_point.py) on the local slice. Returns the (18,)
    pre-mean moment sums; additive across shards (each query contributes
    on exactly its owner, so no mp de-duplication divide is needed).
    """
    glayout = group_rows_by_bin(
        bin_of_query, n_r_local + 1, query_capacity, (moving_local,))
    mg = glayout.grouped[0][:n_r_local]
    qvalid = glayout.valid[:n_r_local].astype(moving_local.dtype)
    G, b_row = prep_similarity(state.q, state.t, state.s)
    weighted = config.weighting is Weighting.WEIGHTED
    robust = config.robust.value
    P_b = bin_point_moments(
        mg, qvalid, local.reps, local.bins_centered, local.sq_b_masked,
        G, b_row, params.alpha, weighted=weighted, robust=robust,
        robust_delta=params.robust_delta)
    return point_moment_partials(P_b, local.reps, local.moment_w)


def _grouped_pairs(local: RBCIndex, tm: jnp.ndarray, params: ICPParams,
                   config: ICPConfig, bin_of_query: jnp.ndarray,
                   n_r_local: int, query_capacity: int,
                   extra_rows: jnp.ndarray):
    """Grouped correspondence pairs on the owner shard (PLANE/GICP path).

    Returns flattened (n_r_local*cq, ...) arrays: (moving, matched fixed,
    nn distance, pair mask, matched fixed normals, extra per-query rows).
    """
    glayout = group_rows_by_bin(
        bin_of_query, n_r_local + 1, query_capacity, (tm, extra_rows))
    tg = glayout.grouped[0][:n_r_local]
    eg = glayout.grouped[1][:n_r_local]
    qvalid = glayout.valid[:n_r_local]

    qc = tg - local.reps[:, None, :]
    w8 = metric_weights(params.alpha, tm.dtype)
    qg_w = qc * w8
    best_score, matched_g, matched_n = bin_phase2(
        local.bins, local.bins_centered, local.sq_b_masked,
        local.bin_normals, qg_w, with_normals=config.needs_normals)
    # Residual from the matched row, not the cancelled score expansion.
    best_d2 = jnp.sum(w8 * (tg - matched_g) ** 2, axis=-1)
    valid = qvalid & jnp.isfinite(best_score)

    n_rows = n_r_local * tg.shape[1]
    flat = lambda x: x.reshape((n_rows,) + x.shape[2:])
    return (flat(tg), flat(matched_g), flat(best_d2), flat(valid),
            flat(matched_n), flat(eg))


def sharded_icp_step(state: ICPState, moving_local: jnp.ndarray,
                     index: RBCIndex, params: ICPParams, config: ICPConfig,
                     n_r_local: int, query_capacity: int,
                     mnormals_local: Optional[jnp.ndarray] = None) -> ICPState:
    """One ICP iteration with dp-sharded queries and mp-sharded bins.

    Call INSIDE shard_map over a (dp, mp) mesh.
    """
    both = (DP_AXIS, MP_AXIS)
    mp_size = jax.lax.axis_size(MP_AXIS)
    # Adaptive robust scale needs per-pair residuals for the distributed
    # median, so it routes POINT through the grouped-pairs path below (the
    # fused moment kernel never materializes d2) — same policy as the
    # single-chip step (icp.step).
    adaptive = config.robust_adaptive and config.robust.value != "none"

    if config.correspondence is Correspondence.RBC:
        local = _slice_index_for_mp(index, n_r_local)
        tm = transform_points(moving_local, state.q, state.t, state.s)
        bin_of_query = _phase1_owned_bins(local, tm, params, n_r_local)

        if config.objective is Objective.POINT and not adaptive:
            # Fused grouped-moments path: one 18-float psum, no scatter.
            sums = _point_partials(local, moving_local, state, params,
                                   config, bin_of_query, n_r_local,
                                   query_capacity)
            S11, mean_f, mean_m, _W = assemble_point_moments(
                jax.lax.psum(sums, both), params.c)
            qk, tk, sk = solve_step_transform(
                S11, mean_f, mean_m, mode=config.rotation.value,
                estimate_scale=config.estimate_scale)
            return _accumulate(state, qk, tk, sk)

        # PLANE/GICP (and adaptive-robust POINT) need per-pair rows; keep
        # them grouped on the owner.
        # Moving-side validity rides in query lane 7 (from the ORIGINAL
        # coordinates — a transformed invalid point sits at t, not 0).
        mv_valid = (jnp.sum(jnp.abs(moving_local[..., :3]), axis=-1) > 0
                    ).astype(moving_local.dtype)
        tm = tm.at[:, 7].set(mv_valid)
        if ((config.objective is Objective.PLANE and config.plane_symmetric)
                or config.objective is Objective.GICP):
            extra_rows = qrotate(state.q, mnormals_local)
        else:
            extra_rows = jnp.zeros((tm.shape[0], 0), tm.dtype)
        mv, matched_f, nn_dist, mask, matched_n, extra = _grouped_pairs(
            local, tm, params, config, bin_of_query, n_r_local,
            query_capacity, extra_rows)
        mask = mask & (mv[..., 7] > 0.5) & (
            jnp.sum(jnp.abs(matched_f[..., :3]), axis=-1) > 0)
        mp_dup = 1  # each query reduced on exactly one (dp, mp) shard
    else:
        # Brute mode: full distance matrix against the replicated db; every
        # mp shard computes identical partials (divide after the psum).
        tm = transform_points(moving_local, state.q, state.t, state.s)
        d2 = pairwise_sq_dists(tm, index.db, params.alpha)
        nn_id = jnp.argmin(d2, axis=1)
        nn_dist = jnp.min(d2, axis=1)
        matched_f = index.db[nn_id]
        matched_n = (index.normals[nn_id] if config.needs_normals
                     else jnp.zeros((tm.shape[0], 3), tm.dtype))
        extra = (qrotate(state.q, mnormals_local)
                 if config.objective is Objective.GICP
                 else jnp.zeros((tm.shape[0], 0), tm.dtype))
        mv = tm
        mask = jnp.logical_and(
            jnp.sum(jnp.abs(moving_local[..., :3]), axis=-1) > 0,
            jnp.sum(jnp.abs(matched_f[..., :3]), axis=-1) > 0)
        mp_dup = mp_size

    if config.weighting is Weighting.WEIGHTED or \
            config.robust.value != "none":
        w = (compute_weights(nn_dist)
             if config.weighting is Weighting.WEIGHTED
             else jnp.ones_like(nn_dist))
        if config.robust.value != "none":
            delta = (adaptive_robust_delta_sharded(
                         nn_dist, mask, config.robust.value, both)
                     if adaptive else params.robust_delta)
            w = w * robust_factor(nn_dist, config.robust.value, delta)
    else:
        w = None

    if config.objective is Objective.PLANE:
        # Point-to-plane: per-shard 6x6 partials, one psum, replicated solve.
        from icp_tpu.icp.plane import plane_system_partials, solve_plane_system

        if config.plane_symmetric:
            matched_n = matched_n + extra[..., :3]
        H, b = plane_system_partials(mv[..., :3], matched_f[..., :3],
                                     matched_n, w, mask)
        H = jax.lax.psum(H, both) / mp_dup
        b = jax.lax.psum(b, both) / mp_dup
        qk, tk = solve_plane_system(H, b)
        sk = jnp.ones((), tm.dtype)
    elif config.objective is Objective.GICP:
        # Plane-to-plane Mahalanobis partials; same psum contract as PLANE.
        from icp_tpu.icp.gicp import gicp_system_partials
        from icp_tpu.icp.plane import solve_plane_system

        H, b = gicp_system_partials(mv[..., :3], matched_f[..., :3],
                                    matched_n, extra[..., :3],
                                    params.gicp_epsilon, w, mask)
        H = jax.lax.psum(H, both) / mp_dup
        b = jax.lax.psum(b, both) / mp_dup
        qk, tk = solve_plane_system(H, b)
        sk = jnp.ones((), tm.dtype)
    else:
        # POINT via brute or via the grouped RBC pairs (adaptive-robust
        # mode): centroid/S partials (the plain RBC POINT path returned
        # above through the fused grouped-moments branch).
        sum_f, sum_m, denom = centroid_partials(matched_f, mv, w, mask)
        sum_f = jax.lax.psum(sum_f, both) / mp_dup
        sum_m = jax.lax.psum(sum_m, both) / mp_dup
        denom = jax.lax.psum(denom, both) / mp_dup
        mean_f = sum_f / denom
        mean_m = sum_m / denom

        dev_f = deviations(matched_f, mean_f)
        dev_m = deviations(mv, mean_m)
        S11 = s_matrix(dev_m, dev_f, params.c, w, mask)
        S11 = jax.lax.psum(S11, both) / mp_dup

        qk, tk, sk = solve_step_transform(
            S11, mean_f, mean_m,
            mode=config.rotation.value,
            estimate_scale=config.estimate_scale)

    return _accumulate(state, qk, tk, sk)


def _accumulate(state: ICPState, qk, tk, sk) -> ICPState:
    """Reference accumulation rule (cpp:3491-3494):
    R = R_k R;  t = s_k R_k t + t_k;  s = s_k s."""
    q = qnormalize(qmul(qk, state.q))
    t = sk * qrotate(qk, state.t) + tk
    s = sk * state.s
    return ICPState(q=q, t=t, s=s, qk=qk, tk=tk, sk=sk, k=state.k + 1)


def sharded_icp_run(moving_local, index, params, config,
                    n_r_local, query_capacity,
                    mnormals_local=None) -> ICPState:
    """Device-resident convergence loop (inside shard_map)."""
    state = identity_state(moving_local.dtype)

    # Convergence computed in-body and carried as a flag — keeps the cond
    # to scalar logic on carried values (see icp.run.icp_run: evaluated in
    # the cond, converged() becomes a run of tiny kernel launches between
    # iterations). All shards compute identical state, so
    # the flag agrees across the mesh.
    def cond(carry):
        s, done = carry
        return jnp.logical_and(
            s.k < config.max_iterations,
            jnp.logical_or(s.k == 0, jnp.logical_not(done)),
        )

    def body(carry):
        s, _ = carry
        ns = sharded_icp_step(s, moving_local, index, params, config,
                              n_r_local, query_capacity,
                              mnormals_local=mnormals_local)
        return ns, converged(ns, params)

    final, _ = jax.lax.while_loop(cond, body, (state, jnp.bool_(False)))
    return final


def make_sharded_register(mesh, config: ICPConfig):
    """Build the jitted multi-chip registration entry point.

    Layout: fixed landmarks replicated, moving landmarks sharded over dp
    (replicated over mp). Returns ``fn(fixed8, moving8, params) -> ICPState``.
    """
    n_dp = mesh.shape[DP_AXIS]
    n_mp = mesh.shape[MP_AXIS]
    if config.n_r % n_mp != 0:
        raise ValueError("n_r must divide evenly over the mp axis")
    if config.m % n_dp != 0:
        raise ValueError("m must divide evenly over the dp axis")
    n_r_local = config.n_r // n_mp
    m_local = config.m // n_dp
    # Local query capacity: dp-local queries spread over the FULL rep
    # range, so each locally-owned bin expects mu = m_local / n_r =
    # (m / n_r) / n_dp queries from this shard. The configured (or auto)
    # single-chip capacity scales by the same 1 / n_dp — but a pure
    # multiplier under-provisions at small local means, where occupancy
    # VARIANCE is relatively larger (Poisson tail: P(occ > 1.5 mu) grows
    # as mu shrinks), so floor it at mu + 4 sqrt(mu) (~1e-4 tail under
    # Poisson; real scans cluster worse, and overflow is a silent
    # rep-fallback). 8-aligned (whole query tiles); n_dp=1 reproduces the
    # single-chip capacity exactly.
    mu = max(m_local // config.n_r, 1)
    floor = mu + int(4 * mu ** 0.5)
    cap = max((config.query_capacity + n_dp - 1) // n_dp, floor)
    query_capacity = max(((cap + 7) // 8) * 8, 8)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(DP_AXIS, None), P(DP_AXIS, None), P()),
             out_specs=P(),
             check_vma=False)
    def _run(fixed8, moving_local, mnormals_local, params):
        rep_ids = sample_representative_indices(
            fixed8.shape[0], config.n_r, config.rep_grid)
        if config.needs_normals:
            from icp_tpu.ops.normals import normals_for

            normals = normals_for(fixed8, config.normal_mode)
        else:
            normals = None
        index = rbc_construct(fixed8, fixed8[rep_ids], params.alpha,
                              config.bin_capacity, rep_db_ids=rep_ids,
                              normals=normals)
        return sharded_icp_run(moving_local, index, params, config,
                               n_r_local, query_capacity,
                               mnormals_local=mnormals_local)

    @jax.jit
    def run(fixed8, moving8, params):
        # Moving normals need the FULL organized grid, so they are computed
        # before the shard_map and row-sharded alongside the moving points
        # (GICP only; a cheap zero placeholder otherwise keeps one spec).
        if config.objective is Objective.GICP:
            from icp_tpu.ops.normals import normals_for

            mnormals = normals_for(moving8, config.normal_mode)
        else:
            mnormals = jnp.zeros((moving8.shape[0], 3), moving8.dtype)
        return _run(fixed8, moving8, mnormals, params)

    return run
