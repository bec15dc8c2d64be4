"""Fused POINT pipeline (rbc/fused_point.py) parity tests.

Three layers of evidence, mirroring SURVEY.md §4's golden strategy:
  1. step-level: `icp_step(fused_point=True)` == `icp_step(fused_point=False)`
     at a random accumulated state (transform folded into the search vs
     explicit);
  2. kernel-level: the GPU kernels in the Pallas interpreter == their
     plain-XLA twins (the production CPU path);
  3. end-to-end: one fused solve recovers a known transform.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from icp_tpu.icp.state import identity_state
from icp_tpu.kernels import kernel_mode
from icp_tpu.icp.step import icp_step
from icp_tpu.rbc.construct import rbc_construct
from icp_tpu.rbc.search import rbc_point_moments
from icp_tpu.runtime.config import ICPConfig, ICPParams, Weighting
from tests.utils import make_cloud8, random_quat

ALPHA = 150.0
C = 1e-6


def _setup(rng, n=512, n_r=16, cap=64):
    db = make_cloud8(rng, n)
    reps = db[rng.choice(n, n_r, replace=False)]
    idx = rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                        jnp.float32(ALPHA), cap)
    moving = make_cloud8(rng, n)
    return idx, jnp.asarray(moving)


def _random_state(rng):
    q = jnp.asarray(random_quat(rng, 0.05))
    t = jnp.asarray((rng.normal(size=3) * 10).astype(np.float32))
    return identity_state()._replace(q=q, t=t)


PARAMS = ICPParams(alpha=ALPHA, c=C).as_f32()


@pytest.mark.parametrize("weighting", [Weighting.WEIGHTED, Weighting.REGULAR])
def test_fused_step_matches_unfused(rng, weighting):
    """The fused POINT path produces the same iteration as the grouped
    search + XLA-reduction path, at a non-identity accumulated state."""
    idx, moving = _setup(rng)
    state = _random_state(rng)
    base = dict(m=moving.shape[0], n_r=idx.reps.shape[0],
                query_capacity=64, weighting=weighting)
    s_fused = icp_step(state, moving, idx, PARAMS,
                       ICPConfig(**base, fused_point=True))
    s_ref = icp_step(state, moving, idx, PARAMS,
                     ICPConfig(**base, fused_point=False))
    np.testing.assert_allclose(np.asarray(s_fused.q), np.asarray(s_ref.q),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_fused.t), np.asarray(s_ref.t),
                               atol=0.05)


@pytest.mark.parametrize("weighted", [True, False])
def test_pallas_kernels_match_ref_twins(rng, weighted):
    """Interpret-mode Pallas kernels == plain-XLA twins."""
    idx, moving = _setup(rng)
    state = _random_state(rng)
    with kernel_mode("interpret"):
        out_k = rbc_point_moments(idx, moving, state.q, state.t, state.s,
                                  jnp.float32(ALPHA), jnp.float32(C), 64,
                                  weighted=weighted)
    out_r = rbc_point_moments(idx, moving, state.q, state.t, state.s,
                              jnp.float32(ALPHA), jnp.float32(C), 64,
                              weighted=weighted)
    for a, b, name in zip(out_k, out_r, ("S11", "mean_f", "mean_m", "W")):
        a, b = np.asarray(a), np.asarray(b)
        tol = 1e-4 * max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)


def test_fused_invalid_points_dropped(rng):
    """Zero-geometry (invalid sensor) moving points must not contribute:
    kernels/icp_kernels.cl:50-51's deferred discard, done in the search
    front."""
    idx, moving = _setup(rng)
    state = _random_state(rng)
    # Zero out a block of points; the moments must match computing on the
    # valid subset alone. Compare fused outputs: full-with-zeros vs padded
    # clone where invalid rows are zero too (identical by construction),
    # vs the unfused step which implements the discard independently.
    moving = moving.at[100:200].set(0.0)
    base = dict(m=moving.shape[0], n_r=idx.reps.shape[0],
                query_capacity=64, weighting=Weighting.WEIGHTED)
    s_fused = icp_step(state, moving, idx, PARAMS,
                       ICPConfig(**base, fused_point=True))
    s_ref = icp_step(state, moving, idx, PARAMS,
                     ICPConfig(**base, fused_point=False))
    np.testing.assert_allclose(np.asarray(s_fused.q), np.asarray(s_ref.q),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_fused.t), np.asarray(s_ref.t),
                               atol=0.05)


def test_hoisted_translation_tensor_matches_direct(rng):
    """point_moment_partials via the hoisted W_t matvec == the direct
    per-term algebra, at realistic rep magnitudes (the coefficients carry
    r_d*r_e ~ 4e6 products — this pins the matmul path's f32 fidelity)."""
    from icp_tpu.rbc.fused_point import (
        point_moment_partials,
        point_translation_tensor,
    )

    reps = jnp.asarray(make_cloud8(rng, 32))
    P = jnp.asarray(rng.normal(size=(32, 8, 8)).astype(np.float32) * 50.0)
    direct = point_moment_partials(P, reps)
    fast = point_moment_partials(P, reps, point_translation_tensor(reps))
    np.testing.assert_allclose(np.asarray(fast), np.asarray(direct),
                               rtol=2e-5, atol=1e-2)


def test_fused_transform_recovery(rng):
    """End-to-end sanity: one fused-step solve from a small offset moves
    strongly toward the known truth (interpret-mode kernels)."""
    from icp_tpu.icp.horn import solve_step_transform
    from icp_tpu.icp.quaternion import qconj, qrotate

    db = make_cloud8(rng, 512)
    q_true = random_quat(rng, 0.02)
    t_true = (rng.normal(size=3) * 5).astype(np.float32)
    queries = db.copy()
    qi = qconj(jnp.asarray(q_true))
    queries[:, :3] = np.asarray(
        qrotate(qi, jnp.asarray(db[:, :3] - t_true)))

    reps = db[rng.choice(512, 16, replace=False)]
    idx = rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                        jnp.float32(ALPHA), 64)
    ident = identity_state()
    with kernel_mode("interpret"):
        S, mf, mm, W = rbc_point_moments(
            idx, jnp.asarray(queries), ident.q, ident.t, ident.s,
            jnp.float32(ALPHA), jnp.float32(C), 64, weighted=True)
    qk, tk, sk = solve_step_transform(S, mf, mm, mode="power",
                                      estimate_scale=False)
    err0 = np.linalg.norm(t_true)
    err1 = np.linalg.norm(np.asarray(tk) - t_true)
    assert err1 < err0 * 0.5, (err0, err1)
