"""Horn absolute-orientation solvers: rotation from the cross-covariance S.

Two jit-compatible, fully on-device modes mirroring the reference's variants:

* :func:`solve_rotation_power` — quaternion power method on Horn's 4x4 N
  matrix, re-designed from the single-work-item ``icpPowerMethod`` OpenCL
  task (reference kernels/icp_kernels.cl:976-1054) as a bounded
  ``lax.while_loop``.
* :func:`solve_rotation_svd` — SVD solve R = V * diag(1, 1, det) * U^T,
  mirroring the reference's host-side Eigen JacobiSVD path (reference
  src/ICP/algorithms.cpp:3474-3487) but running on-device so the ICP loop
  never leaves the chip.

S layout (the 11-vector produced by :mod:`icp_tpu.ops.moments`, matching the
``icpSijProducts`` output order, reference kernels/icp_kernels.cl:660-670)::

    S11 = [Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz, sum|f'|^2, sum|m'|^2]

with ``S[3i+j] = sum_k m_dev[k,i] * f_dev[k,j]`` and the symmetric-scale
constituents last; ``s_k = sqrt(S[9]/S[10])`` (reference cpp:3471).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from icp_tpu.icp.quaternion import matrix_to_quat, qnormalize, qrotate

_POWER_MAX_ITER = 1000  # reference kernels/icp_kernels.cl:1007


def build_N(S9: jnp.ndarray) -> jnp.ndarray:
    """Horn's 4x4 N matrix in [x, y, z, w] quaternion basis.

    Layout matches reference kernels/icp_kernels.cl:993-999.

    Args:
      S9: (9,) flattened cross-covariance, S9[3i+j] = sum m_i f_j.
    Returns:
      (4, 4) symmetric matrix whose dominant (most positive eigenvalue)
      eigenvector is the optimal rotation quaternion.
    """
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = [S9[i] for i in range(9)]
    return jnp.array(
        [
            [Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz, Syz - Szy],
            [Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy, Szx - Sxz],
            [Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz, Sxy - Syx],
            [Syz - Szy, Szx - Sxz, Sxy - Syx, Sxx + Syy + Szz],
        ],
        dtype=S9.dtype,
    )


_POWER_SQUARINGS = 8  # N^(2^8) = 256 effective power iterations


def solve_rotation_power(S9: jnp.ndarray) -> jnp.ndarray:
    """Dominant-most-positive-eigenvector quaternion via the power method,
    shaped for an accelerator.

    The reference runs a scalar fixed-point loop of normalize(N x) steps
    (~56 iterations) with a shift-and-retry when the dominant-magnitude
    eigenvalue is negative (kernels/icp_kernels.cl:1001-1037). A sequential
    4-vector loop is the worst shape for an accelerator (each tiny op pays
    a fixed launch or pipeline latency), so the same quantity is computed
    as:

      1. shift N' = N + r I with r = the Gershgorin bound max_i sum_j |N_ij|
         (>= -lambda_min), making every eigenvalue nonnegative — the
         most-POSITIVE eigenvalue of N becomes the dominant one by
         construction, eliminating the reference's data-dependent retry;
      2. 8 normalized matrix squarings: M = (N'/|N'|)^(2^8) — equivalent to
         256 power iterations, in 8 unrolled 4x4 matmuls;
      3. q = normalize(M @ ones(4)), the reference's starting vector.

    Convergence is strictly stronger than the reference's (ratio^256 vs
    ratio^56 eigenvalue separation), with identical semantics: the returned
    eigenvector of Horn's N maximizes the rotation objective.

    Returns:
      (4,) unit quaternion [x, y, z, w], sign-canonicalized (w >= 0): q and
      -q are the same rotation, but the convergence metric
      2*atan2(|v|, w) is not sign-invariant.
    """
    N = build_N(S9)
    r = jnp.max(jnp.sum(jnp.abs(N), axis=1))
    M = N + r * jnp.eye(4, dtype=N.dtype)
    hi = jax.lax.Precision.HIGHEST
    for _ in range(_POWER_SQUARINGS):
        M = M / jnp.max(jnp.abs(M))
        M = jnp.dot(M, M, precision=hi)
    x = jnp.dot(M, jnp.ones((4,), N.dtype), precision=hi)
    # Reference epilogue: one extra un-normalized multiply by N' then an
    # exact normalize (kernels/icp_kernels.cl:1039-1041) — also polishes the
    # squaring result.
    q = qnormalize(jnp.dot(N + r * jnp.eye(4, dtype=N.dtype), x, precision=hi))
    return q * jnp.where(q[3] < 0, -1.0, 1.0)


def solve_rotation_jacobi(S9: jnp.ndarray) -> jnp.ndarray:
    """Rotation via a full symmetric eigensolve of Horn's N matrix.

    Implements the reference's declared-but-todo JACOBI variant
    (``ICPStepConfigT::JACOBI``, include/ICP/algorithms.hpp:1544-1564):
    eigendecompose the 4x4 N and take the most-POSITIVE eigenvalue's
    eigenvector — exact where the power method iterates.

    Returns:
      (4,) unit quaternion [x, y, z, w], sign-canonicalized (w >= 0).
    """
    N = build_N(S9)
    _, vecs = jnp.linalg.eigh(N)  # ascending eigenvalues
    q = qnormalize(vecs[:, -1])
    return q * jnp.where(q[3] < 0, -1.0, 1.0)


def solve_rotation_svd(S9: jnp.ndarray) -> jnp.ndarray:
    """Rotation via SVD of the 3x3 cross-covariance, with reflection fix.

    R = V * diag(1, 1, det(V U^T)) * U^T  (reference cpp:3477-3487).

    Returns:
      (4,) unit quaternion [x, y, z, w].
    """
    S = S9.reshape(3, 3)
    U, _, Vt = jnp.linalg.svd(S)
    V = Vt.T
    R0 = V @ U.T
    d = jnp.linalg.det(R0)
    B = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype=S.dtype).at[2].set(d))
    R = V @ B @ U.T
    return matrix_to_quat(R)


_ROTATION_SOLVERS = {
    "power": solve_rotation_power,
    "svd": solve_rotation_svd,
    "jacobi": solve_rotation_jacobi,
}


def solve_step_transform(S11: jnp.ndarray, mean_f: jnp.ndarray,
                         mean_m: jnp.ndarray, *, use_power: bool = True,
                         mode: str | None = None,
                         estimate_scale: bool = True):
    """Incremental transform (q_k, t_k, s_k) for one ICP iteration.

    s_k = sqrt(S[9] / S[10]) — Horn's symmetric scale, the ratio of the
    (c-scaled) deviation energies (reference cpp:3471; the c scaling cancels).
    t_k = mean_f - s_k * R(q_k) * mean_m  (reference cpp:3489 / cl:1050).

    Args:
      S11: (11,) S-matrix vector (see module docstring).
      mean_f: (3,) fixed-set centroid.
      mean_m: (3,) moving-set centroid.
      use_power: legacy static flag (power vs svd); superseded by ``mode``.
      mode: "power" | "svd" | "jacobi" (RotationMode.value); overrides
        ``use_power`` when given.
      estimate_scale: solve for s_k (reference behavior); False pins
        s_k = 1 (rigid mode — see ICPConfig.estimate_scale).
    Returns:
      (qk (4,), tk (3,), sk scalar).
    """
    # Degenerate-frame guard (sensor dropout: every pair masked out). All
    # moments are then exactly 0: sqrt(0/0) and the power method's
    # M/max|M| both produce NaN and permanently poison the accumulated
    # state (the centroid path already guards its 0/0 — this is the solve
    # side of the same contract). Identity q / unit s is the no-information
    # answer.
    degenerate = jnp.max(jnp.abs(S11)) <= 0.0
    if estimate_scale:
        safe_den = jnp.where(S11[10] > 0, S11[10], 1.0)
        sk = jnp.where(S11[10] > 0, jnp.sqrt(S11[9] / safe_den),
                       jnp.ones((), S11.dtype))
    else:
        sk = jnp.ones((), S11.dtype)
    if mode is None:
        mode = "power" if use_power else "svd"
    # Feed the solver an identity cross-covariance when degenerate so no
    # NaN is ever produced (a select alone would still evaluate the NaN
    # branch; eigensolves on NaN input are undefined).
    eye9 = jnp.eye(3, dtype=S11.dtype).reshape(9)
    S9_safe = jnp.where(degenerate, eye9, S11[:9])
    qk = _ROTATION_SOLVERS[mode](S9_safe)
    tk = mean_f - sk * qrotate(qk, mean_m)
    return qk, tk, sk
