"""Bundle adjustment with Schur-complement reduction — the distributed
mapping backend (BASELINE.json config 5; no reference counterpart).

Problem: keyframe poses X_k (world_from_camera) and map points p_l observed
as 3-D camera-frame measurements z_o (RGB-D gives depth, so observations are
3-D points, not 2-D projections):

    r_o = z_o - X_{cam(o)}^-1 p_{pt(o)}

Gauss-Newton normal system has the classic BA structure: dense 6N x 6N
camera block Hcc, block-diagonal 3x3 landmark blocks Hll, and sparse
camera-landmark coupling W. Landmarks are eliminated via the Schur
complement

    S  = Hcc - W Hll^-1 W^T ,   rhs = bc - W Hll^-1 bp

then the reduced camera system is solved densely (N is keyframe-count
small) and landmarks are back-substituted independently.

Structure:
  * per-observation Jacobians: vmapped forward-mode autodiff (3x6, 3x3).
  * Hll / bp: segment-sums over observations grouped by landmark.
  * W-products: observations grouped by landmark with a fixed max-degree
    capacity (icp_tpu.rbc.grouping reused), so the Schur cross terms are
    one batched einsum + a block scatter-add.
  * distributed form (``ba_solve_sharded``): landmarks and their
    observations sharded over ``dp``; each shard computes partial S and
    rhs, ONE ``psum`` combines them (the Schur-complement-over-collectives
    design of SURVEY.md §2.6), the tiny camera solve is replicated, and
    back-substitution stays local to each shard.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from icp_tpu.rbc.grouping import group_by_bin
from icp_tpu.slam import se3


class BAProblem(NamedTuple):
    """Struct-of-arrays bundle-adjustment problem.

    Attributes:
      pose_q: (N, 4) keyframe orientations (world_from_camera).
      pose_t: (N, 3) keyframe positions.
      points: (L, 3) map points (world frame).
      obs_cam: (O,) keyframe index per observation.
      obs_point: (O,) map-point index per observation.
      obs_z: (O, 3) measured camera-frame point.
      obs_w: (O,) scalar weight per observation.
    """

    pose_q: jnp.ndarray
    pose_t: jnp.ndarray
    points: jnp.ndarray
    obs_cam: jnp.ndarray
    obs_point: jnp.ndarray
    obs_z: jnp.ndarray
    obs_w: jnp.ndarray


def _residual(xi_cam, dp, pose: se3.Pose, point, z):
    """r = z - (retract(X, xi))^-1 (p + dp)."""
    X = se3.retract(pose, xi_cam)
    pred = se3.apply(se3.inverse(X), point + dp)
    return z - pred


def _obs_jacobians(pose: se3.Pose, point, z):
    zero6 = jnp.zeros((6,), point.dtype)
    zero3 = jnp.zeros((3,), point.dtype)
    r0 = _residual(zero6, zero3, pose, point, z)
    A = jax.jacfwd(lambda xi: _residual(xi, zero3, pose, point, z))(zero6)
    B = jax.jacfwd(lambda dp: _residual(zero6, dp, pose, point, z))(zero3)
    return r0, A, B  # (3,), (3, 6), (3, 3)


def _linearize(problem: BAProblem):
    poses = se3.Pose(problem.pose_q[problem.obs_cam],
                     problem.pose_t[problem.obs_cam])
    pts = problem.points[problem.obs_point]
    r0, A, B = jax.vmap(_obs_jacobians)(poses, pts, problem.obs_z)
    w = problem.obs_w[:, None, None]
    return r0, A, B, w


def _schur_system(problem: BAProblem, r0, A, B, w, max_degree: int,
                  damping: float):
    """Build (S (6N, 6N), rhs (6N,), Hll_inv (L, 3, 3), bp (L, 3), group)."""
    n = problem.pose_q.shape[0]
    L = problem.points.shape[0]

    At_w = jnp.swapaxes(A, 1, 2) * jnp.swapaxes(w, 1, 2)  # (O, 6, 3)
    hi = jax.lax.Precision.HIGHEST
    Hcc_blocks = jnp.matmul(At_w, A, precision=hi)  # (O, 6, 6)
    bc_blocks = jnp.einsum("oij,oj->oi", At_w, r0, precision=hi)  # (O, 6)
    C = jnp.matmul(At_w, B, precision=hi)  # (O, 6, 3)  — the W blocks per observation

    Bt_w = jnp.swapaxes(B, 1, 2) * jnp.swapaxes(w, 1, 2)
    Hll_blocks = jnp.matmul(Bt_w, B, precision=hi)  # (O, 3, 3)
    bp_blocks = jnp.einsum("oij,oj->oi", Bt_w, r0, precision=hi)  # (O, 3)

    # Landmark-indexed reductions.
    Hll = jnp.zeros((L, 3, 3), A.dtype).at[problem.obs_point].add(Hll_blocks)
    bp = jnp.zeros((L, 3), A.dtype).at[problem.obs_point].add(bp_blocks)
    Hll = Hll + damping * jnp.eye(3, dtype=A.dtype)
    Hll_inv = jnp.linalg.inv(Hll)

    # Camera-indexed reductions.
    Hcc = jnp.zeros((n, 6, n, 6), A.dtype)
    Hcc = Hcc.at[problem.obs_cam, :, problem.obs_cam, :].add(Hcc_blocks)
    bc = jnp.zeros((n, 6), A.dtype).at[problem.obs_cam].add(bc_blocks)

    # Schur cross terms via fixed-degree grouping of observations by point.
    g = group_by_bin(problem.obs_point.astype(jnp.int32), L, max_degree)
    Cg = jnp.where(g.valid[..., None, None], C[g.member], 0.0)  # (L, D, 6, 3)
    cam_g = problem.obs_cam[g.member]  # (L, D)
    T = jnp.einsum("ldik,lkm->ldim", Cg, Hll_inv, precision=hi)  # (L, D, 6, 3)
    cross = jnp.einsum("ldim,lejm->ldeij", T, Cg, precision=hi)  # (L, D, D, 6, 6)

    li = jnp.broadcast_to(cam_g[:, :, None], cross.shape[:3]).reshape(-1)
    lj = jnp.broadcast_to(cam_g[:, None, :], cross.shape[:3]).reshape(-1)
    Hcc = Hcc.at[li, :, lj, :].add(-cross.reshape(-1, 6, 6))

    # rhs reduction: bc - W Hll^-1 bp.
    y = jnp.einsum("lkm,lm->lk", Hll_inv, bp, precision=hi)  # (L, 3)
    rhs_cross = jnp.einsum("ldim,lm->ldi", Cg, y, precision=hi)  # (L, D, 6)
    bc = bc.at[cam_g.reshape(-1)].add(
        -rhs_cross.reshape(-1, 6))

    S = Hcc.reshape(6 * n, 6 * n)
    rhs = bc.reshape(6 * n)
    return S, rhs, Hll_inv, bp, C, g


def check_max_degree(obs_point, n_points: int, max_degree: int) -> int:
    """Validate that no landmark exceeds the fixed-degree capacity.

    The Schur cross terms and back-substitution group observations by
    landmark with a fixed ``max_degree`` capacity (group_by_bin); overflow
    observations would be SILENTLY dropped from those terms while Hll/Hcc
    keep them, biasing the reduced system. Raises ValueError on overflow;
    returns the actual max degree. Call with concrete (host) arrays —
    sharded callers should validate each shard's slice before dispatch.
    """
    import numpy as np

    counts = np.bincount(np.asarray(obs_point), minlength=n_points)
    actual = int(counts.max()) if counts.size else 0
    if actual > max_degree:
        raise ValueError(
            f"landmark observation degree {actual} exceeds max_degree="
            f"{max_degree}: excess observations would be silently dropped "
            f"from the Schur cross terms — raise max_degree to >= {actual}")
    return actual


def ba_solve(problem: BAProblem, iterations: int = 5, max_degree: int = 8,
             damping: float = 1e-4, fix_first: bool = True) -> BAProblem:
    """Gauss-Newton BA with Schur elimination (single device).

    Validates the fixed-degree capacity on concrete inputs (traced inputs —
    e.g. under an outer jit — skip the check; use :func:`check_max_degree`
    yourself in that case)."""
    try:
        check_max_degree(problem.obs_point, problem.points.shape[0],
                         max_degree)
    except jax.errors.TracerArrayConversionError:
        pass
    return _ba_solve(problem, iterations=iterations, max_degree=max_degree,
                     damping=damping, fix_first=fix_first)


@partial(jax.jit, static_argnames=("iterations", "max_degree", "fix_first"))
def _ba_solve(problem: BAProblem, iterations: int = 5, max_degree: int = 8,
              damping: float = 1e-4, fix_first: bool = True) -> BAProblem:
    n = problem.pose_q.shape[0]

    def gn(carry, _):
        prob = carry
        r0, A, B, w = _linearize(prob)
        S, rhs, Hll_inv, bp, C, g = _schur_system(prob, r0, A, B, w,
                                                  max_degree, damping)
        if fix_first:
            anchor = jnp.zeros((6 * n,), S.dtype).at[:6].set(1e12)
            S = S + jnp.diag(anchor)
        S = S + damping * jnp.eye(6 * n, dtype=S.dtype)
        dx_c = -jnp.linalg.solve(S, rhs).reshape(n, 6)

        # Back-substitute landmarks: dp = -Hll^-1 (bp + W^T dx_c).
        cam_g = prob.obs_cam[g.member]
        Cg = jnp.where(g.valid[..., None, None], C[g.member], 0.0)
        wtx = jnp.einsum("ldim,ldi->lm", Cg, dx_c[cam_g], precision=jax.lax.Precision.HIGHEST)  # (L, 3)
        dp = -jnp.einsum("lkm,lm->lk", Hll_inv, bp + wtx, precision=jax.lax.Precision.HIGHEST)

        new_pose = jax.vmap(
            lambda q, t, xi: se3.retract(se3.Pose(q, t), xi))(
            prob.pose_q, prob.pose_t, dx_c)
        cost = jnp.sum(r0 * r0 * prob.obs_w[:, None])
        return prob._replace(pose_q=new_pose.q, pose_t=new_pose.t,
                             points=prob.points + dp), cost

    out, costs = jax.lax.scan(gn, problem, None, length=iterations)
    return out


def ba_cost(problem: BAProblem) -> jnp.ndarray:
    r0, _, _, _ = _linearize(problem)
    return jnp.sum(r0 * r0 * problem.obs_w[:, None])


def make_sharded_ba(mesh, n_cams: int, iterations: int = 5,
                    max_degree: int = 8, damping: float = 1e-4,
                    fix_first: bool = True):
    """Distributed BA: landmarks + their observations sharded over ``dp``.

    Sharding contract: the caller partitions LANDMARKS over dp and passes,
    per shard, the local slice of ``points`` plus ALL observations of those
    landmarks (observation ``obs_point`` indices are LOCAL). Poses are
    replicated (the keyframe set is small).

    Per GN iteration each shard computes its local Schur partial
    S_local = Hcc_local - W Hll^-1 W^T and rhs partial from its landmarks,
    ONE ``psum`` over dp combines them (the Schur-complement-over-
    collectives design of SURVEY.md §2.6), the dense (6N)^2 camera solve is
    replicated, and landmark back-substitution is shard-local. Per-iteration
    collective payload: (6N)^2 + 6N floats.

    Returns ``run(problem_local) -> problem_local`` to be called on
    dp-sharded ``BAProblem`` pytrees under ``jit`` (in_specs via shard_map).

    Capacity contract: validate each shard's slice with
    :func:`check_max_degree` before dispatch — overflow observations are
    silently dropped from the Schur cross terms (inputs here are traced, so
    the solver cannot check for you).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from icp_tpu.parallel.mesh import DP_AXIS

    n = n_cams

    def gn_local(prob: BAProblem) -> BAProblem:
        def one_iter(carry, _):
            p = carry
            r0, A, B, w = _linearize(p)
            S, rhs, Hll_inv, bp, C, g = _schur_system(
                p, r0, A, B, w, max_degree, damping)
            # Combine Schur partials across landmark shards.
            S = jax.lax.psum(S, DP_AXIS)
            rhs = jax.lax.psum(rhs, DP_AXIS)
            if fix_first:
                anchor = jnp.zeros((6 * n,), S.dtype).at[:6].set(1e12)
                S = S + jnp.diag(anchor)
            S = S + damping * jnp.eye(6 * n, dtype=S.dtype)
            dx_c = -jnp.linalg.solve(S, rhs).reshape(n, 6)

            cam_g = p.obs_cam[g.member]
            Cg = jnp.where(g.valid[..., None, None], C[g.member], 0.0)
            wtx = jnp.einsum("ldim,ldi->lm", Cg, dx_c[cam_g], precision=jax.lax.Precision.HIGHEST)
            dp_pts = -jnp.einsum("lkm,lm->lk", Hll_inv, bp + wtx, precision=jax.lax.Precision.HIGHEST)

            new_pose = jax.vmap(
                lambda q, t, xi: se3.retract(se3.Pose(q, t), xi))(
                p.pose_q, p.pose_t, dx_c)
            return p._replace(pose_q=new_pose.q, pose_t=new_pose.t,
                              points=p.points + dp_pts), None

        out, _ = jax.lax.scan(one_iter, prob, None, length=iterations)
        return out

    sharded = shard_map(
        gn_local, mesh=mesh,
        in_specs=(BAProblem(
            pose_q=P(), pose_t=P(),
            points=P(DP_AXIS),
            obs_cam=P(DP_AXIS), obs_point=P(DP_AXIS),
            obs_z=P(DP_AXIS), obs_w=P(DP_AXIS),
        ),),
        out_specs=BAProblem(
            pose_q=P(), pose_t=P(),
            points=P(DP_AXIS),
            obs_cam=P(DP_AXIS), obs_point=P(DP_AXIS),
            obs_z=P(DP_AXIS), obs_w=P(DP_AXIS),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)
