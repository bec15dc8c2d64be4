"""Generalized-ICP (plane-to-plane) incremental solver.

Accuracy extension over the reference (point-to-point only, see
src/ICP/algorithms.cpp:3460-3501): each point carries a "disk" covariance

    C = I - (1 - eps) n n^T        (eps thin along the surface normal n)

and each pair is weighted by the 3x3 Mahalanobis matrix

    W_i = (C_f,i + R C_m,i R^T)^{-1}

(Segal, Haehnel, Thrun — "Generalized-ICP", RSS 2009). One linearized
Gauss-Newton step per ICP iteration:

    r_i = R m_i + t - f_i                    (3-vector residual)
    J_i = [ I_3 | -[R m_i]_x / L ]           (3x6; d/dt, d/d(L*omega))
    (sum J^T W J) [t; L*omega] = -(sum J^T W r)

Zero normals degrade C to the identity (isotropic), so the objective
reduces to half-weighted point-to-point on unstructured data — no special
casing needed for invalid-normal rows.

Device mapping: everything is batched (n, 3, 3) / (n, 3, 6) elementwise work
plus three einsum contractions; the 3x3 inverse is a closed-form adjugate
(no per-point LU), and the 6x6 solve is replicated-tiny. All contractions
run at Precision.HIGHEST (bf16 default would drown sub-0.01 mm steps).
Unit balancing (L = CHARACTERISTIC_LENGTH_MM) matches icp_tpu.icp.plane.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from icp_tpu.icp.plane import CHARACTERISTIC_LENGTH_MM, solve_plane_system

_HI = jax.lax.Precision.HIGHEST


def disk_covariance_sum(n_f: jnp.ndarray, n_m: jnp.ndarray,
                        epsilon) -> jnp.ndarray:
    """M_i = C_f,i + C_m,i for disk covariances C = I - (1 - eps) n n^T.

    Args:
      n_f: (n, 3) fixed-surface unit normals (zero rows allowed).
      n_m: (n, 3) moving-surface normals ALREADY rotated into the fixed
        frame (zero rows allowed).
      epsilon: disk thickness along the normal.
    Returns:
      (n, 3, 3) symmetric positive-definite matrices; eigenvalues lie in
      [2*eps, 2] for unit normals, so the closed-form inverse is safe in
      f32.
    """
    eye = jnp.eye(3, dtype=n_f.dtype)
    outer_f = n_f[:, :, None] * n_f[:, None, :]
    outer_m = n_m[:, :, None] * n_m[:, None, :]
    return 2.0 * eye - (1.0 - epsilon) * (outer_f + outer_m)


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse via the adjugate (no LU; pure
    elementwise VPU work, shape (n, 3, 3))."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = jnp.stack([
        jnp.stack([A, B, C], axis=-1),
        jnp.stack([D, E, F], axis=-1),
        jnp.stack([G, H, I], axis=-1),
    ], axis=-2)
    safe = jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    return adj / safe[..., None, None]


def gicp_system_partials(mv_xyz: jnp.ndarray, f_xyz: jnp.ndarray,
                         n_f: jnp.ndarray, n_m: jnp.ndarray,
                         epsilon,
                         weights: Optional[jnp.ndarray] = None,
                         mask: Optional[jnp.ndarray] = None):
    """Shard-local (H (6, 6), b (6,)) partial sums of the GICP GN system —
    psum-compatible across shards (same contract as
    icp_tpu.icp.plane.plane_system_partials). Rotation block pre-scaled by
    1/CHARACTERISTIC_LENGTH_MM."""
    dtype = mv_xyz.dtype
    r = mv_xyz - f_xyz  # (n, 3)
    W = inv3x3(disk_covariance_sum(n_f, n_m, epsilon))  # (n, 3, 3)

    w = jnp.ones(mv_xyz.shape[0], dtype) if weights is None else weights
    if mask is not None:
        w = jnp.where(mask, w, 0.0)
    W = W * w[:, None, None]

    # J_i = [I | -[mv]_x / L]  -> (n, 3, 6)
    L = CHARACTERISTIC_LENGTH_MM
    x, y, z = mv_xyz[:, 0] / L, mv_xyz[:, 1] / L, mv_xyz[:, 2] / L
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    # -[p]_x = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
    J = jnp.stack([
        jnp.stack([one, zero, zero, zero, z, -y], axis=-1),
        jnp.stack([zero, one, zero, -z, zero, x], axis=-1),
        jnp.stack([zero, zero, one, y, -x, zero], axis=-1),
    ], axis=-2)  # (n, 3, 6)

    WJ = jnp.einsum("nkl,nlb->nkb", W, J, precision=_HI)
    H = jnp.einsum("nka,nkb->ab", J, WJ, precision=_HI)
    b = jnp.einsum("nkb,nk->b", WJ, r, precision=_HI)
    return H, b


def solve_gicp(mv_xyz: jnp.ndarray, f_xyz: jnp.ndarray,
               n_f: jnp.ndarray, n_m: jnp.ndarray,
               epsilon,
               weights: Optional[jnp.ndarray] = None,
               mask: Optional[jnp.ndarray] = None,
               damping: float = 1e-6):
    """One GN step of the GICP plane-to-plane objective.

    Args:
      mv_xyz: (n, 3) transformed moving points (fixed frame).
      f_xyz: (n, 3) matched fixed points.
      n_f: (n, 3) fixed-surface normals (zero rows -> isotropic).
      n_m: (n, 3) moving-surface normals rotated into the fixed frame.
      epsilon: disk-covariance thickness (ICPParams.gicp_epsilon).
      weights, mask: optional per-pair scalar weight / validity.
    Returns:
      (qk (4,) unit quaternion, tk (3,)) — the incremental rigid transform.
    """
    H, b = gicp_system_partials(mv_xyz, f_xyz, n_f, n_m, epsilon,
                                weights, mask)
    return solve_plane_system(H, b, damping)
