"""Point-to-plane incremental solver — an accuracy extension over the
reference (which is point-to-point only).

Point-to-point ICP against a sampled surface has a tangential bias floor set
by the sample pitch (~15 mm on a wall at 2 m for the reference's landmark
grid): matches lock onto the lattice and increments vanish. The
point-to-plane objective

    min_{omega, t}  sum_i w_i ((R m_i + t - f_i) . n_i)^2

constrains only the normal direction, letting points slide along the
surface to the true optimum. One linearized Gauss-Newton step per ICP
iteration (standard small-angle form: R m ~ m + omega x m):

    r_i = (m_i - f_i) . n_i
    J_i = [ n_i ;  m_i x n_i ]           (d/dt ; d/domega)
    (sum w J J^T) [t; omega] = -(sum w J r)

The 6x6 solve is tiny; the row reductions are one (6, m) x (m, 6)
product. Scale is not part of this objective (s_k = 1).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from icp_tpu.icp.quaternion import qnormalize

# Unit balancing: translation columns of J are O(1) (unit normals) while
# rotation columns (m x n) are O(|m|) ~ 2000 mm for Kinect data, giving
# cond(H) ~ |m|^2 ~ 4e6 — an f32 solve would drown the sub-0.01 mm
# increments this objective exists to resolve. Solving for [t; L*omega]
# with rotation columns divided by L rebalances H to O(1) conditioning.
# A fixed (static) length keeps the partials psum-compatible across shards.
CHARACTERISTIC_LENGTH_MM = 1.0e3


def plane_system_partials(mv_xyz: jnp.ndarray, f_xyz: jnp.ndarray,
                          normals: jnp.ndarray,
                          weights: Optional[jnp.ndarray] = None,
                          mask: Optional[jnp.ndarray] = None):
    """Shard-local (H (6, 6), b (6,)) partial sums of the GN normal system —
    psum these across shards, then :func:`solve_plane_system` (distributed
    form used by icp_tpu.parallel). Rotation block is pre-scaled by
    1/CHARACTERISTIC_LENGTH_MM (see module constant)."""
    r = jnp.sum((mv_xyz - f_xyz) * normals, axis=-1)
    J = jnp.concatenate(
        [normals, jnp.cross(mv_xyz, normals) / CHARACTERISTIC_LENGTH_MM],
        axis=-1)
    w = jnp.ones_like(r) if weights is None else weights
    if mask is not None:
        w = jnp.where(mask, w, 0.0)
    Jw = J * w[:, None]
    H = jnp.dot(Jw.T, J, precision=jax.lax.Precision.HIGHEST)
    b = jnp.dot(Jw.T, r, precision=jax.lax.Precision.HIGHEST)
    return H, b


def solve_plane_system(H: jnp.ndarray, b: jnp.ndarray,
                       damping: float = 1e-6):
    """Solve the (possibly psum-combined) 6x6 system -> (qk, tk).

    The system is in balanced units ([t; L*omega], see
    CHARACTERISTIC_LENGTH_MM); the rotation part is unscaled here."""
    H = H + damping * jnp.eye(6, dtype=H.dtype)
    delta = -jnp.linalg.solve(H, b)
    tk = delta[:3]
    omega = delta[3:] / CHARACTERISTIC_LENGTH_MM
    angle = jnp.linalg.norm(omega)
    safe = jnp.where(angle > 1e-12, angle, 1.0)
    axis = omega / safe
    half = 0.5 * angle
    qk = jnp.concatenate([jnp.sin(half) * axis, jnp.cos(half)[None]])
    qk = jnp.where(angle > 1e-12, qk,
                   jnp.array([0.0, 0.0, 0.0, 1.0], H.dtype))
    return qnormalize(qk), tk


def solve_point_to_plane(mv_xyz: jnp.ndarray, f_xyz: jnp.ndarray,
                         normals: jnp.ndarray,
                         weights: Optional[jnp.ndarray] = None,
                         mask: Optional[jnp.ndarray] = None,
                         damping: float = 1e-6):
    """One GN step of the point-to-plane objective.

    Args:
      mv_xyz: (n, 3) transformed moving points.
      f_xyz: (n, 3) matched fixed points.
      normals: (n, 3) fixed-surface unit normals (zero rows = no
        constraint; they self-mask via |n| = 0).
      weights: optional (n,) residual weights.
      mask: optional (n,) validity mask.
    Returns:
      (qk (4,) unit quaternion, tk (3,)) — the incremental transform.
    """
    H, b = plane_system_partials(mv_xyz, f_xyz, normals, weights, mask)
    return solve_plane_system(H, b, damping)
