"""Fused Gauss-Newton moments for the normal-consuming objectives.

Extends the fused POINT iteration (rbc/fused_point.py) to PLANE,
symmetric PLANE and GICP: the same per-bin search (``bin_nn``), then the
whole GN system build reduces into the same (n_r, 8, 8) per-bin moment
layout.

The unifying algebra: every GN row of these objectives has the form

    v = [u, m x u, u . (m - f), 1]          (8 lanes)

for a direction u with a per-row weight g — the point-to-plane row with
u = n, g = 1 (or the symmetric n_f + R n_m). GICP's 3x3 Mahalanobis
denominator M = C_f + R C_m R^T = 2I - (1-eps)(n_f n_f^T + n_m n_m^T)
(icp.gicp.disk_covariance_sum) has the exact sqrt-free inverse

    M^{-1} = I/2 + e/(4 L_s) s s^T + e/(4 L_t) t t^T
    s = n_f + n_m,  t = n_f - n_m,  c = n_f . n_m,  e = 1 - eps
    L_s = 2 - e (1 + c),  L_t = 2 - e (1 - c)

(s and t are orthogonal for unit/zero normals, diagonalizing the rank-2
update; eigenvalue floor 2 eps keeps the divides f32-safe). Since
J^T M^{-1} J decomposes over M^{-1}'s rank-1 terms and
u^T J = [u ; m x u] (J = [I | -[m]_x], cross product linear in u),
GICP = two data rows (u = s, g = e/4L_s and u = t, g = e/4L_t) plus the
isotropic I/2 term, carried as a second moment P_z = sum w z z^T over
z = [m, d, 1, 0]; :func:`gicp_const_moment` expands P_z into the three
constant-direction rows' moment sum. No per-pair eigendecomposition, no
3x3 solves.

The per-bin moment matrix P_b = sum_i w_i v_i v_i^T (m CENTERED on the
bin representative, m x u in raw mm) then carries the whole system:
translation to the global frame is the per-bin congruence V = sum_b
T_b P_b T_b^T with T_b = I + skew(rep_b) in the (3:6, 0:3) block — linear
in P, so it is hoisted into a (n_b, 8, 8, 64) coefficient tensor at index
build time exactly like the POINT translation (point_translation_tensor).
After unit balancing (1/L on the rotation rows/cols):

    H = V[0:6, 0:6],  b = V[0:6, 6],  sum w r^2 = V[6, 6],  3?sum w = V[7,7]

feed icp_tpu.icp.plane.solve_plane_system unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from icp_tpu.rbc.fused_point import _HI, _search_core

GN_MODES = ("plane", "plane_sym", "gicp")


def bin_gn_moments(mg: jnp.ndarray, nm: jnp.ndarray | None,
                   qvalid: jnp.ndarray, reps: jnp.ndarray,
                   bins_c: jnp.ndarray, bins_vals: jnp.ndarray,
                   sq_b_masked: jnp.ndarray, G: jnp.ndarray,
                   b_row: jnp.ndarray, alpha, *, mode: str, weighted: bool,
                   robust: str = "none", robust_delta=0.0, gicp_eps=0.0):
    """Per-bin search + weighting + GN-row moment reduction.

    Args:
      mg: (n_r, cq, 8) bin-grouped RAW moving rows.
      nm: (n_r, cq, 3) grouped moving normals rotated into the fixed frame
        (required for "plane_sym"/"gicp"; None for "plane").
      qvalid: (n_r, cq) f32 slot validity from the grouping.
      reps: (n_r, 8) representatives (per-bin centering).
      bins_c: (n_r, cb, 8) rep-centered bin points (the search input).
      bins_vals: (n_r, cb, 12) = [rep-centered bin points | normals | 0]
        (RBCIndex.bins_vals12), the matched-row gather payload.
      sq_b_masked: (n_r, cb) masked |b|^2 (+inf on invalid slots).
      G, b_row: accumulated similarity (fused_point.prep_similarity).
      alpha: photometric blend (traced scalar).
      mode: "plane" | "plane_sym" | "gicp" (static).
      weighted / robust / robust_delta: residual weighting as in POINT
        (reference icpComputeReduceWeights x robust IRLS factor).
      gicp_eps: disk-covariance thickness (traced; gicp mode only).
    Returns:
      (n_r, 8, 8) per-bin GN moment matrices P_b in the rep-centered
      frame; gicp returns the pair (P_b, P_z_b) — callers add
      ``gicp_const_moment(P_z)`` to P before the global congruence.
    """
    assert mode in GN_MODES, mode
    dt = mg.dtype
    qc, matched, w = _search_core(
        mg, qvalid, reps, bins_c, sq_b_masked, bins_vals, G, b_row,
        jnp.asarray(alpha, dt), weighted, robust,
        jnp.asarray(robust_delta, dt))  # matched: (n_r, cq, 12)
    m = qc[..., :3]
    d = m - matched[..., :3]
    nf = matched[..., 8:11]

    def row(u):
        # v = [u, m x u, u . (m - f), 1]
        return jnp.concatenate(
            [u, jnp.cross(m, u), jnp.sum(d * u, axis=-1, keepdims=True),
             jnp.ones_like(u[..., :1])], axis=-1)

    def moment(v, wr):
        return jnp.einsum("bqi,bqj->bij", v * wr[..., None], v,
                          precision=_HI)

    if mode == "plane":
        return moment(row(nf), w)
    if mode == "plane_sym":
        # Rusinkiewicz symmetric objective: constrain along the averaged
        # fixed+moving normal (zero rows self-mask to the one-sided case).
        return moment(row(nf + nm), w)
    # GICP: M = 2I - (1-eps)(nf nf^T + nm nm^T). For unit (or zero)
    # normals s = nf + nm and t = nf - nm are orthogonal, which
    # diagonalizes the rank-2 update and gives the EXACT sqrt-free inverse
    # (Woodbury, module docstring; L_* >= 2 eps keeps the divides
    # f32-safe, verified against np.linalg.inv incl. parallel /
    # anti-parallel / missing normals in tests/test_fused_gn.py). The
    # isotropic I/2 term's three constant-direction rows are linear in the
    # z-moment P_z, assembled by gicp_const_moment on (n_r, 8, 8) tensors.
    e = 1.0 - jnp.asarray(gicp_eps, dt)
    cth = jnp.sum(nf * nm, axis=-1)
    gs = e / (4.0 * (2.0 - e * (1.0 + cth)))
    gt = e / (4.0 * (2.0 - e * (1.0 - cth)))
    P = moment(row(nf + nm), w * gs) + moment(row(nf - nm), w * gt)
    one = jnp.ones_like(m[..., :1])
    z = jnp.concatenate([m, d, one, jnp.zeros_like(one)], axis=-1)
    return P, moment(z, w)


def gicp_const_moment(P_z: jnp.ndarray) -> jnp.ndarray:
    """GICP's isotropic-I/2 moment block from the z-moment.

    The three constant-direction GN rows v_k = B e_k with
    B = [I3; skew(m); d^T; 1^T] (8 x 3) sum to sum_i (w_i/2) B_i B_i^T —
    every entry of B B^T is at most quadratic in (m, d), so the sum is a
    LINEAR function of P_z = sum_i w_i z_i z_i^T, z = [m, d, 1, 0]. This
    expands it on the (n_b, 8, 8) tensors. Block identities used
    (S := skew(m)): S S^T = |m|^2 I - m m^T;  S d = m x d;  S 1 = m x 1.
    """
    Mm = P_z[:, 0:3, 0:3]
    Md = P_z[:, 3:6, 3:6]
    Mmd = P_z[:, 0:3, 3:6]
    sw = P_z[:, 6, 6]
    sm = P_z[:, 0:3, 6]
    sd = P_z[:, 3:6, 6]
    dt = P_z.dtype
    eye3 = jnp.eye(3, dtype=dt)

    def skew(v):
        z = jnp.zeros_like(v[:, 0])
        return jnp.stack([
            jnp.stack([z, -v[:, 2], v[:, 1]], -1),
            jnp.stack([v[:, 2], z, -v[:, 0]], -1),
            jnp.stack([-v[:, 1], v[:, 0], z], -1)], -2)

    S_sm = skew(sm)
    cross_md = jnp.stack([Mmd[:, 1, 2] - Mmd[:, 2, 1],
                          Mmd[:, 2, 0] - Mmd[:, 0, 2],
                          Mmd[:, 0, 1] - Mmd[:, 1, 0]], -1)  # sum w m x d
    m_x_1 = jnp.stack([sm[:, 1] - sm[:, 2],
                       sm[:, 2] - sm[:, 0],
                       sm[:, 0] - sm[:, 1]], -1)             # sum w m x 1
    tr_Mm = jnp.trace(Mm, axis1=1, axis2=2)
    tr_Md = jnp.trace(Md, axis1=1, axis2=2)
    ones3 = jnp.ones((3,), dt)

    top = jnp.concatenate([
        sw[:, None, None] * eye3, -S_sm, sd[:, :, None],
        sw[:, None, None] * ones3[:, None]], axis=2)          # (n_b, 3, 8)
    mid = jnp.concatenate([
        S_sm, tr_Mm[:, None, None] * eye3 - Mm, cross_md[:, :, None],
        m_x_1[:, :, None]], axis=2)                           # (n_b, 3, 8)
    r6 = jnp.concatenate([
        sd, cross_md, tr_Md[:, None],
        jnp.sum(sd, axis=1, keepdims=True)], axis=1)[:, None] # (n_b, 1, 8)
    r7 = jnp.concatenate([
        sw[:, None] * ones3, m_x_1, jnp.sum(sd, axis=1, keepdims=True),
        3.0 * sw[:, None]], axis=1)[:, None]                  # (n_b, 1, 8)
    return 0.5 * jnp.concatenate([top, mid, r6, r7], axis=1)


# ---------------------------------------------------------------------------
# Assembly: per-bin P matrices -> global GN system
# ---------------------------------------------------------------------------


def _gn_T(reps: jnp.ndarray) -> jnp.ndarray:
    """(n_b, 8, 8) per-bin frame-translation congruence factors:
    identity + skew(rep_xyz) in the (3:6, 0:3) block, so that
    v_global = T v_local (m x u picks up rep x u when de-centering m)."""
    n_b = reps.shape[0]
    rx, ry, rz = reps[:, 0], reps[:, 1], reps[:, 2]
    z = jnp.zeros_like(rx)
    S = jnp.stack([jnp.stack([z, -rz, ry], -1),
                   jnp.stack([rz, z, -rx], -1),
                   jnp.stack([-ry, rx, z], -1)], -2)  # (n_b, 3, 3)
    T = jnp.tile(jnp.eye(8, dtype=reps.dtype), (n_b, 1, 1))
    return T.at[:, 3:6, 0:3].set(S)


def gn_v_total(P: jnp.ndarray, reps: jnp.ndarray,
               W_t: jnp.ndarray | None = None) -> jnp.ndarray:
    """Global (8, 8) GN moment matrix V = sum_b T_b P_b T_b^T.

    Additive across disjoint bin sets — shards ``psum`` this 64-float
    matrix (the entire per-iteration PLANE/GICP collective payload).
    With W_t (:func:`gn_translation_tensor`) the congruence is one hoisted
    matvec, like the POINT translation.
    """
    if W_t is not None:
        n_b = P.shape[0]
        return jax.lax.dot_general(
            P.reshape(1, n_b * 64), W_t.reshape(n_b * 64, 64),
            (((1,), (0,)), ((), ())), precision=_HI).reshape(8, 8)
    T = _gn_T(reps)
    return jnp.einsum("bij,bjk,blk->il", T, P, T, precision=_HI)


def gn_translation_tensor(reps: jnp.ndarray) -> jnp.ndarray:
    """Hoisted (n_b, 8, 8, 64) coefficients of :func:`gn_v_total` (linear
    in P, coefficients from the loop-invariant reps — same jacrev trick as
    fused_point.point_translation_tensor)."""
    jac = jax.jacrev(
        lambda P: gn_v_total(P, reps).reshape(64))(
        jnp.zeros((reps.shape[0], 8, 8), reps.dtype))  # (64, n_b, 8, 8)
    return jnp.transpose(jac, (1, 2, 3, 0))


def gn_system_from_V(V: jnp.ndarray, L: float):
    """(H (6, 6), b (6,)) in icp.plane's balanced units from the global V.

    The moments build m x u in raw millimeters; dividing the rotation
    rows/cols by L here reproduces plane_system_partials' J = [u ;
    (m x u) / L] balancing exactly (see icp.plane.CHARACTERISTIC_LENGTH_MM).
    """
    d = jnp.concatenate([jnp.ones((3,), V.dtype),
                         jnp.full((3,), 1.0 / L, V.dtype),
                         jnp.ones((2,), V.dtype)])
    Vs = V * d[:, None] * d[None, :]
    return Vs[0:6, 0:6], Vs[0:6, 6]
