"""Fused PLANE/GICP pipeline (rbc/fused_gn.py) parity tests.

Same three-layer evidence as the fused POINT tests (test_fused_moments):
  1. step-level: `icp_step(fused_gn=True)` == the grouped-search path, at
     a random accumulated state, for PLANE / symmetric PLANE / GICP;
  2. kernel-level: the interpreted GPU kernels == the plain-XLA twins, and
     the per-bin moments == the GN rows built pair by pair;
  3. algebra-level: the Woodbury row decomposition reproduces inv(M)
     exactly, and the hoisted translation tensor matches the direct
     per-bin congruence.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from icp_tpu.icp.state import identity_state
from icp_tpu.icp.step import icp_step
from icp_tpu.ops.normals import normals_for
from icp_tpu.rbc.construct import rbc_construct
from icp_tpu.rbc.search import rbc_gn_system
from icp_tpu.runtime.config import ICPConfig, ICPParams, Objective, Weighting
from tests.utils import make_cloud8, random_quat

ALPHA = 150.0


def _setup(rng, n=512, n_r=16, cap=64):
    db = make_cloud8(rng, n)
    reps = db[rng.choice(n, n_r, replace=False)]
    normals = np.asarray(normals_for(jnp.asarray(db), "knn"))
    idx = rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                        jnp.float32(ALPHA), cap,
                        normals=jnp.asarray(normals))
    moving = make_cloud8(rng, n)
    return idx, jnp.asarray(moving)


def _random_state(rng):
    q = jnp.asarray(random_quat(rng, 0.05))
    t = jnp.asarray((rng.normal(size=3) * 10).astype(np.float32))
    return identity_state()._replace(q=q, t=t)


PARAMS = ICPParams(alpha=ALPHA).as_f32()


@pytest.mark.parametrize("objective,symmetric,weighting", [
    (Objective.PLANE, False, Weighting.WEIGHTED),
    (Objective.PLANE, True, Weighting.REGULAR),
    (Objective.GICP, False, Weighting.WEIGHTED),
])
def test_fused_gn_step_matches_unfused(rng, objective, symmetric, weighting):
    """The fused GN path produces the same iteration as the grouped-search
    + XLA GN-reduction path, at a non-identity accumulated state."""
    idx, moving = _setup(rng)
    state = _random_state(rng)
    mnormals = normals_for(moving, "knn")
    base = dict(m=moving.shape[0], n_r=idx.reps.shape[0],
                query_capacity=64, objective=objective,
                plane_symmetric=symmetric, weighting=weighting,
                normal_mode="knn", estimate_scale=False)
    s_fused = icp_step(state, moving, idx, PARAMS,
                       ICPConfig(**base, fused_gn=True),
                       moving_normals=mnormals)
    s_ref = icp_step(state, moving, idx, PARAMS,
                     ICPConfig(**base, fused_gn=False),
                     moving_normals=mnormals)
    np.testing.assert_allclose(np.asarray(s_fused.qk), np.asarray(s_ref.qk),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_fused.tk), np.asarray(s_ref.tk),
                               atol=0.05)


@pytest.mark.parametrize("mode", ["plane", "plane_sym", "gicp"])
def test_gn_kernel_matches_ref_twin(rng, mode):
    """Interpret-mode Pallas kernels == plain-XLA twins."""
    from icp_tpu.kernels import kernel_mode

    idx, moving = _setup(rng)
    state = _random_state(rng)
    mn = normals_for(moving, "knn") if mode != "plane" else None
    kwargs = dict(mode=mode, weighted=True, gicp_eps=1e-3,
                  mnormals_rot=mn)
    with kernel_mode("interpret"):
        V_k = rbc_gn_system(idx, moving, state.q, state.t, state.s,
                            jnp.float32(ALPHA), 64, **kwargs)
    V_r = rbc_gn_system(idx, moving, state.q, state.t, state.s,
                        jnp.float32(ALPHA), 64, **kwargs)
    tol = 1e-4 * max(float(jnp.max(jnp.abs(V_r))), 1.0)
    np.testing.assert_allclose(np.asarray(V_k), np.asarray(V_r), atol=tol)


@pytest.mark.parametrize("mode", ["plane", "plane_sym", "gicp"])
def test_gn_moments_match_pair_rows(rng, mode):
    """bin_gn_moments == the GN rows built pair by pair in float64 numpy
    from each grouped query's nearest bin slot."""
    from icp_tpu.ops.distance import metric_weights
    from icp_tpu.rbc.fused_gn import bin_gn_moments
    from icp_tpu.rbc.grouping import group_rows_by_bin
    from icp_tpu.rbc.search import rbc_point_assign_counts

    idx, moving = _setup(rng)
    state = _random_state(rng)
    mn = normals_for(moving, "knn")
    rid, counts, G, b_row = rbc_point_assign_counts(
        idx, moving, state.q, state.t, state.s, jnp.float32(ALPHA))
    gl = group_rows_by_bin(rid, idx.reps.shape[0], 64, (moving, mn),
                           counts=counts)
    mg, nm = gl.grouped
    qvalid = gl.valid.astype(moving.dtype)
    eps = 1e-3
    P = bin_gn_moments(mg, None if mode == "plane" else nm, qvalid,
                       idx.reps, idx.bins_centered, idx.bins_vals12,
                       idx.sq_b_masked, G, b_row, jnp.float32(ALPHA),
                       mode=mode, weighted=False, gicp_eps=eps)

    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    mg, nm, G, b_row = f64(mg), f64(nm), f64(G), f64(b_row)
    reps, bins_c = f64(idx.reps), f64(idx.bins_centered)
    vals, sq_b = f64(idx.bins_vals12), f64(idx.sq_b_masked)
    qc = mg @ G + b_row - reps[:, None, :]
    w8 = f64(metric_weights(ALPHA))
    score = sq_b[:, None, :] - 2.0 * np.einsum("bqk,bck->bqc", qc * w8,
                                                 bins_c)
    slot = np.argmin(score, axis=-1)
    w = (np.asarray(gl.valid) & (np.abs(mg[..., :3]).sum(-1) > 0)
         & np.isfinite(score.min(-1))).astype(np.float64)
    matched = np.take_along_axis(vals, slot[..., None], axis=1)
    m, d, nf = qc[..., :3], qc[..., :3] - matched[..., :3], matched[..., 8:11]

    def moment(u, wr):
        v = np.concatenate([u, np.cross(m, u), (d * u).sum(-1)[..., None],
                            np.ones_like(u[..., :1])], axis=-1)
        return np.einsum("bqi,bq,bqj->bij", v, wr, v)

    if mode == "plane":
        want = [moment(nf, w)]
    elif mode == "plane_sym":
        want = [moment(nf + nm, w)]
    else:
        e = 1.0 - eps
        c = (nf * nm).sum(-1)
        gs, gt = e / (4 * (2 - e * (1 + c))), e / (4 * (2 - e * (1 - c)))
        z = np.concatenate([m, d, np.ones_like(m[..., :1]),
                            np.zeros_like(m[..., :1])], axis=-1)
        want = [moment(nf + nm, w * gs) + moment(nf - nm, w * gt),
                np.einsum("bqi,bq,bqj->bij", z, w, z)]
    got = P if mode == "gicp" else [P]
    for g, wnt in zip(got, want):
        tol = 1e-4 * max(np.abs(wnt).max(), 1.0)
        np.testing.assert_allclose(np.asarray(g), wnt, atol=tol)


def test_gicp_woodbury_rows_reproduce_inverse(rng):
    """I/2 + e/(4 L_s) s s^T + e/(4 L_t) t t^T == inv(M) — the exact
    sqrt-free identity that lets GICP's 3x3 Mahalanobis weight run as
    three constant-direction rows (g = 1/2) plus two data rows (see
    rbc/fused_gn.py docstring). Validity domain: unit or zero
    normals (s and t are then orthogonal eigen-directions of the rank-2
    update), including the parallel / anti-parallel extremes where the
    smallest eigenvalue hits the 2 eps floor."""
    eps = 1e-3
    nf = rng.normal(size=(64, 3)).astype(np.float32)
    nf /= np.linalg.norm(nf, axis=1, keepdims=True)
    nm = rng.normal(size=(64, 3)).astype(np.float32)
    nm /= np.linalg.norm(nm, axis=1, keepdims=True)
    nm[:8] = nf[:8]        # parallel normals (the common aligned case)
    nm[8:16] = -nf[8:16]   # anti-parallel
    nf[16:24] = 0.0        # missing normals -> isotropic
    nm[20:28] = 0.0        # (overlapping: both missing on 20:24)
    e = 1.0 - eps
    M = (2.0 * np.eye(3, dtype=np.float32)
         - e * (nf[:, :, None] * nf[:, None, :]
                + nm[:, :, None] * nm[:, None, :]))
    c = np.sum(nf * nm, axis=1)
    s, t = nf + nm, nf - nm
    g_s = (e / (4.0 * (2.0 - e * (1.0 + c))))[:, None, None]
    g_t = (e / (4.0 * (2.0 - e * (1.0 - c))))[:, None, None]
    got = (0.5 * np.eye(3, dtype=np.float32)
           + g_s * s[:, :, None] * s[:, None, :]
           + g_t * t[:, :, None] * t[:, None, :])
    want = np.linalg.inv(M)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_gicp_const_moment_matches_row_sum(rng):
    """gicp_const_moment(P_z) == the explicit constant-direction row sum
    sum_i (w_i/2) B_i B_i^T — the linearity that lets GICP's isotropic
    I/2 term ride a single z-moment through the per-bin reduction."""
    from icp_tpu.rbc.fused_gn import gicp_const_moment

    n_b, cq = 5, 16
    m = rng.uniform(-40, 40, (n_b, cq, 3)).astype(np.float32)
    d = rng.uniform(-3, 3, (n_b, cq, 3)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (n_b, cq)).astype(np.float32)

    want = np.zeros((n_b, 8, 8), np.float32)
    for b in range(n_b):
        for i in range(cq):
            S = np.array([[0, -m[b, i, 2], m[b, i, 1]],
                          [m[b, i, 2], 0, -m[b, i, 0]],
                          [-m[b, i, 1], m[b, i, 0], 0]], np.float32)
            B = np.concatenate([np.eye(3, dtype=np.float32), S,
                                d[b, i][None], np.ones((1, 3), np.float32)])
            want[b] += 0.5 * w[b, i] * (B @ B.T)

    z = np.concatenate([m, d, np.ones((n_b, cq, 1), np.float32),
                        np.zeros((n_b, cq, 1), np.float32)], axis=-1)
    P_z = jnp.einsum("bqi,bq,bqj->bij", z, w, z)
    got = np.asarray(gicp_const_moment(P_z))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_gn_translation_tensor_matches_direct(rng):
    """gn_v_total via the hoisted W_t matvec == the direct per-bin
    congruence at realistic rep magnitudes."""
    from icp_tpu.rbc.fused_gn import gn_translation_tensor, gn_v_total

    reps = jnp.asarray(make_cloud8(rng, 16))
    P = jnp.asarray(rng.normal(size=(16, 8, 8)).astype(np.float32) * 20.0)
    direct = gn_v_total(P, reps)
    fast = gn_v_total(P, reps, gn_translation_tensor(reps))
    np.testing.assert_allclose(
        np.asarray(fast), np.asarray(direct), rtol=2e-5,
        atol=1e-3 * float(jnp.max(jnp.abs(direct))))


def test_fused_gn_registration_recovers_transform(rng):
    """End-to-end: a fused PLANE registration on a synthetic pair with a
    known transform lands on the truth (the e2e accuracy tests in
    test_plane/test_gicp also route through this path by default)."""
    import icp_tpu
    from icp_tpu.icp.quaternion import (
        qangle_deg, qconj, qmul, qrotate, transform_points)

    n = 2048
    db = make_cloud8(rng, n)
    q = np.array([0.004, 0.009, 0.006, 0.9999], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([8.0, -5.0, 3.0], np.float32)
    qi = qconj(jnp.asarray(q))
    moving = transform_points(jnp.asarray(db), qi,
                              -qrotate(qi, jnp.asarray(t)), jnp.float32(1.0))
    cfg = ICPConfig(m=n, n_r=16, objective=Objective.PLANE,
                    normal_mode="knn", estimate_scale=False)
    assert cfg.fused_gn
    st = icp_tpu.register(jnp.asarray(db), moving, PARAMS, cfg)
    assert float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q))))) < 0.01
    assert float(jnp.max(jnp.abs(st.t - jnp.asarray(t)))) < 0.05
