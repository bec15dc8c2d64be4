"""Robust M-estimator kernels (beyond-reference; runtime.config.RobustKernel).

The reference's only robustness device is the fixed-scale weighting
``w = 100/(100+d^2)`` (kernels/icp_kernels.cl:138-180). The robust kernels
gate gross outliers (occlusions, dynamic objects) out of the solve with a
tunable scale. Evidence layers:
  1. unit: robust_factor values at the kernel breakpoints;
  2. parity: fused POINT path == unfused path, and interpret-mode Pallas
     == XLA twin, with a robust kernel active;
  3. end-to-end: contaminated pairs — REGULAR registration is dragged off
     the truth by outliers, robust variants recover it.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from icp_tpu import (
    Correspondence,
    ICPConfig,
    ICPParams,
    Objective,
    RobustKernel,
    Weighting,
    register,
)
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.icp.state import identity_state
from icp_tpu.icp.step import icp_step
from icp_tpu.ops.moments import robust_factor
from icp_tpu.rbc.construct import rbc_construct
from icp_tpu.rbc.search import rbc_point_moments
from tests.test_icp_e2e import _make_pair
from tests.utils import make_cloud8, random_quat


def test_robust_factor_values():
    d = jnp.asarray([0.0, 25.0, 100.0, 400.0, 1e8], jnp.float32)  # d^2
    delta = jnp.float32(10.0)  # distances 0, 5, 10, 20, 1e4

    np.testing.assert_allclose(
        np.asarray(robust_factor(d, "none", delta)), np.ones(5))
    np.testing.assert_allclose(
        np.asarray(robust_factor(d, "huber", delta)),
        [1.0, 1.0, 1.0, 0.5, 1e-3], rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(robust_factor(d, "tukey", delta)),
        [1.0, 0.5625, 0.0, 0.0, 0.0], rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(robust_factor(d, "trimmed", delta)),
        [1.0, 1.0, 1.0, 0.0, 0.0])
    with pytest.raises(ValueError):
        robust_factor(d, "cauchy", delta)


def _contaminate(rng, moving: np.ndarray, frac: float = 0.12,
                 magnitude: float = 250.0) -> np.ndarray:
    """Displace a fraction of the moving points' geometry by gross offsets
    (the model for occlusions / dynamic objects)."""
    out = moving.copy()
    n = moving.shape[0]
    k = int(n * frac)
    idx = rng.choice(n, k, replace=False)
    out[idx, :3] += rng.uniform(magnitude, 2 * magnitude,
                                (k, 3)).astype(np.float32) * rng.choice(
                                    [-1.0, 1.0], (k, 3)).astype(np.float32)
    return out


# Redescending kernels (Tukey, trimmed) null gross outliers entirely ->
# sub-mm recovery; Huber's linear tail keeps a bounded but NONZERO outlier
# influence (that is its design: efficiency near the truth over full
# rejection), so its residual bias under 12% gross contamination is a few mm.
@pytest.mark.parametrize("robust,t_bound,a_bound", [
    (RobustKernel.TUKEY, 1.0, 0.1),
    (RobustKernel.TRIMMED, 1.0, 0.1),
    (RobustKernel.HUBER, 5.0, 0.5),
])
def test_robust_recovers_under_contamination(rng, robust, t_bound, a_bound):
    """12% gross outliers: REGULAR registration is dragged off the truth;
    the robust kernels recover it. (WEIGHTED's fixed 10-mm Cauchy scale
    already suppresses most of this — the robust kernels add the tunable,
    hard-rejecting versions.)"""
    fixed, moving, q_true, t_true = _make_pair(rng, 4096)
    moving = _contaminate(rng, np.asarray(moving))
    base = dict(m=4096, n_r=64, weighting=Weighting.REGULAR,
                correspondence=Correspondence.RBC, estimate_scale=False)
    params = ICPParams(alpha=2e2, robust_delta=40.0).as_f32()

    plain = register(jnp.asarray(fixed), jnp.asarray(moving), params,
                     ICPConfig(**base))
    rob = register(jnp.asarray(fixed), jnp.asarray(moving), params,
                   ICPConfig(**base, robust=robust))

    t_err_plain = np.linalg.norm(np.asarray(plain.t) - t_true)
    t_err_rob = np.linalg.norm(np.asarray(rob.t) - t_true)
    a_err_rob = float(qangle_deg(qmul(rob.q, qconj(jnp.asarray(q_true)))))

    # Robust lands on (or near, Huber) the truth; plain is dragged off it.
    assert t_err_rob < t_bound, (robust, t_err_rob)
    assert a_err_rob < a_bound, (robust, a_err_rob)
    assert t_err_plain > 2.0 * t_err_rob + 0.5, (t_err_plain, t_err_rob)


def test_robust_composes_with_weighted(rng):
    """WEIGHTED x TRIMMED: the reference weighting and the hard rejection
    compose; registration on contaminated data stays on the truth."""
    fixed, moving, q_true, t_true = _make_pair(rng, 4096)
    moving = _contaminate(rng, np.asarray(moving))
    config = ICPConfig(m=4096, n_r=64, weighting=Weighting.WEIGHTED,
                       robust=RobustKernel.TRIMMED,
                       correspondence=Correspondence.RBC,
                       estimate_scale=False)
    params = ICPParams(alpha=2e2, robust_delta=40.0).as_f32()
    st = register(jnp.asarray(fixed), jnp.asarray(moving), params, config)
    assert np.linalg.norm(np.asarray(st.t) - t_true) < 1.0
    assert float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q_true))))) < 0.1


def test_robust_fused_matches_unfused(rng):
    """The in-kernel robust factor (fused POINT path) equals the step-level
    robust weighting (grouped-search path) at a random accumulated state."""
    db = make_cloud8(rng, 512)
    reps = db[rng.choice(512, 16, replace=False)]
    idx = rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                        jnp.float32(150.0), 64)
    moving = jnp.asarray(make_cloud8(rng, 512))
    state = identity_state()._replace(
        q=jnp.asarray(random_quat(rng, 0.05)),
        t=jnp.asarray((rng.normal(size=3) * 10).astype(np.float32)))
    params = ICPParams(alpha=150.0, robust_delta=60.0).as_f32()
    base = dict(m=512, n_r=16, query_capacity=64,
                weighting=Weighting.REGULAR, robust=RobustKernel.TUKEY)
    s_fused = icp_step(state, moving, idx, params,
                       ICPConfig(**base, fused_point=True))
    s_ref = icp_step(state, moving, idx, params,
                     ICPConfig(**base, fused_point=False))
    np.testing.assert_allclose(np.asarray(s_fused.q), np.asarray(s_ref.q),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_fused.t), np.asarray(s_ref.t),
                               atol=0.05)


@pytest.mark.parametrize("robust", ["huber", "tukey", "trimmed"])
def test_robust_pallas_matches_ref_twin(rng, robust):
    """Interpret-mode Pallas kernels == XLA twins with robust active."""
    from icp_tpu.kernels import kernel_mode

    db = make_cloud8(rng, 512)
    reps = db[rng.choice(512, 16, replace=False)]
    idx = rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                        jnp.float32(150.0), 64)
    moving = jnp.asarray(make_cloud8(rng, 512))
    st = identity_state()
    kw = dict(weighted=True, robust=robust, robust_delta=jnp.float32(60.0))
    with kernel_mode("interpret"):
        out_k = rbc_point_moments(idx, moving, st.q, st.t, st.s,
                                  jnp.float32(150.0), jnp.float32(1e-6), 64,
                                  **kw)
    out_r = rbc_point_moments(idx, moving, st.q, st.t, st.s,
                              jnp.float32(150.0), jnp.float32(1e-6), 64,
                              **kw)
    for a, b, name in zip(out_k, out_r, ("S11", "mean_f", "mean_m", "W")):
        a, b = np.asarray(a), np.asarray(b)
        tol = 1e-4 * max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)


def test_masked_median():
    from icp_tpu.ops.moments import masked_median

    x = jnp.asarray([5.0, 1.0, 9.0, 3.0, 7.0])
    m = jnp.asarray([True, True, False, True, True])
    assert float(masked_median(x, m)) == 3.0  # lower median of {1,3,5,7}
    assert float(masked_median(x, None)) == 5.0
    assert float(masked_median(x, jnp.zeros(5, bool))) == 0.0


@pytest.mark.parametrize("objective", [Objective.POINT, Objective.PLANE])
def test_robust_adaptive_recovers_without_delta(rng, objective):
    """robust_adaptive derives the scale from the residual median — no
    robust_delta tuning — and still rejects 12% gross contamination."""
    fixed, moving, q_true, t_true = _make_pair(rng, 4096)
    moving = _contaminate(rng, np.asarray(moving))
    config = ICPConfig(m=4096, n_r=64, weighting=Weighting.REGULAR,
                       robust=RobustKernel.TUKEY, robust_adaptive=True,
                       objective=objective, estimate_scale=False)
    # Deliberately absurd robust_delta: adaptive mode must ignore it.
    params = ICPParams(alpha=2e2, robust_delta=1e9).as_f32()
    st = register(jnp.asarray(fixed), jnp.asarray(moving), params, config)
    assert np.linalg.norm(np.asarray(st.t) - t_true) < 1.0
    assert float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q_true))))) < 0.1


def test_robust_adaptive_clean_pair_still_converges(rng):
    """On a clean pair the annealing scale must not reject inliers: the
    registration still lands on the truth (floor guard covers the
    all-zero-residual endgame)."""
    fixed, moving, q_true, t_true = _make_pair(rng, 4096)
    config = ICPConfig(m=4096, n_r=64, robust=RobustKernel.TRIMMED,
                       robust_adaptive=True, estimate_scale=False)
    st = register(jnp.asarray(fixed), jnp.asarray(moving),
                  ICPParams(alpha=2e2).as_f32(), config)
    assert np.linalg.norm(np.asarray(st.t) - t_true) < 0.1
    assert float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q_true))))) < 0.01


def test_robust_adaptive_fused_matches_grouped(rng):
    """robust_adaptive on the fused pipeline (d2-only first pass deriving
    the scale, then the in-kernel robust factor) equals the grouped-search
    path's step at a random accumulated state."""
    db = make_cloud8(rng, 512)
    reps = db[rng.choice(512, 16, replace=False)]
    idx = rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                        jnp.float32(150.0), 64)
    moving = jnp.asarray(make_cloud8(rng, 512))
    state = identity_state()._replace(
        q=jnp.asarray(random_quat(rng, 0.05)),
        t=jnp.asarray((rng.normal(size=3) * 10).astype(np.float32)))
    params = ICPParams(alpha=150.0, robust_delta=1e9).as_f32()
    base = dict(m=512, n_r=16, query_capacity=64,
                weighting=Weighting.REGULAR, robust=RobustKernel.TUKEY,
                robust_adaptive=True)
    s_fused = icp_step(state, moving, idx, params,
                       ICPConfig(**base, fused_point=True))
    s_ref = icp_step(state, moving, idx, params,
                     ICPConfig(**base, fused_point=False))
    np.testing.assert_allclose(np.asarray(s_fused.q), np.asarray(s_ref.q),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(s_fused.t), np.asarray(s_ref.t),
                               atol=0.05)


def test_min_dists_pallas_matches_ref_twin(rng):
    """The distance-only pass with the interpreted search kernel == the
    XLA twin (incl. the +inf invalid encoding), and the derived adaptive
    scale matches."""
    from icp_tpu.kernels import kernel_mode
    from icp_tpu.ops.moments import adaptive_robust_delta
    from icp_tpu.rbc.fused_point import bin_min_dists
    from icp_tpu.rbc.grouping import group_rows_by_bin
    from icp_tpu.rbc.search import rbc_point_assign_counts

    db = make_cloud8(rng, 512)
    reps = db[rng.choice(512, 16, replace=False)]
    idx = rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                        jnp.float32(150.0), 64)
    moving = np.asarray(make_cloud8(rng, 512))
    moving[:5] = 0.0  # invalid originals -> +inf slots
    moving = jnp.asarray(moving)
    st = identity_state()
    rid, counts, G, b_row = rbc_point_assign_counts(
        idx, moving, st.q, st.t, st.s, jnp.float32(150.0))
    gl = group_rows_by_bin(rid, 16, 64, (moving,), counts=counts)
    qvalid = gl.valid.astype(moving.dtype)
    args = (gl.grouped[0], qvalid, idx.reps, idx.bins_centered,
            idx.sq_b_masked, G, b_row, jnp.float32(150.0))
    with kernel_mode("interpret"):
        d_k = np.asarray(bin_min_dists(*args))
    d_r = np.asarray(bin_min_dists(*args))
    assert np.array_equal(np.isfinite(d_k), np.isfinite(d_r))
    assert np.isinf(d_k).sum() >= 5  # the zeroed originals are invalid
    fin = np.isfinite(d_r)
    np.testing.assert_allclose(d_k[fin], d_r[fin], rtol=1e-5, atol=1e-3)
    del_k = adaptive_robust_delta(jnp.asarray(d_k).reshape(-1),
                                  jnp.isfinite(d_k).reshape(-1), "tukey")
    del_r = adaptive_robust_delta(jnp.asarray(d_r).reshape(-1),
                                  jnp.isfinite(d_r).reshape(-1), "tukey")
    np.testing.assert_allclose(float(del_k), float(del_r), rtol=1e-4)


def test_robust_adaptive_sharded_supported():
    """robust_adaptive now runs on the sharded path (distributed residual
    median — see tests/test_sharded.py for the accuracy/parity checks);
    building the entry point must not reject it."""
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import make_sharded_register

    cfg = ICPConfig(m=1024, n_r=16, robust=RobustKernel.TUKEY,
                    robust_adaptive=True)
    make_sharded_register(make_mesh(2, 1), cfg)  # must not raise


def test_robust_config_checkpoint_roundtrip():
    from icp_tpu.slam.checkpoint import _config_dict, _config_from_dict

    cfg = ICPConfig(m=1024, n_r=16, robust=RobustKernel.TUKEY)
    back = _config_from_dict(_config_dict(cfg))
    assert back.robust is RobustKernel.TUKEY
    assert back == cfg
