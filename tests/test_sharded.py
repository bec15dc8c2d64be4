"""Multi-chip sharding tests on an 8-virtual-device CPU mesh — the
capability the reference lacks entirely (single OpenCL device, no mocks;
SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icp_tpu import (
    Correspondence,
    ICPConfig,
    ICPParams,
    RotationMode,
    Weighting,
    register,
)
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.parallel.mesh import make_mesh
from icp_tpu.parallel.sharded import make_sharded_register
from tests.test_icp_e2e import _make_pair


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    return _make_pair(rng, 4096, angle=0.03, trans=12.0)


def _check(state, q_true, t_true):
    q_err = qmul(state.q, qconj(jnp.asarray(q_true)))
    assert float(qangle_deg(q_err)) < 0.1
    np.testing.assert_allclose(np.asarray(state.t), t_true, atol=1.5)
    assert abs(float(state.s) - 1.0) < 2e-3


@pytest.mark.parametrize("n_dp,n_mp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_register_matches_truth(pair, n_dp, n_mp):
    fixed, moving, q_true, t_true = pair
    config = ICPConfig(m=4096, n_r=64, rotation=RotationMode.POWER,
                       weighting=Weighting.WEIGHTED,
                       correspondence=Correspondence.RBC)
    mesh = make_mesh(n_dp, n_mp)
    run = make_sharded_register(mesh, config)
    state = jax.block_until_ready(
        run(jnp.asarray(fixed), jnp.asarray(moving), ICPParams(alpha=2e2).as_f32()))
    _check(state, q_true, t_true)


def test_sharded_matches_single_device(pair):
    """Same pair, single-device vs 8-way sharded: transforms must agree to
    reduction-order noise."""
    fixed, moving, q_true, t_true = pair
    config = ICPConfig(m=4096, n_r=64, rotation=RotationMode.POWER,
                       weighting=Weighting.WEIGHTED,
                       correspondence=Correspondence.RBC)
    params = ICPParams(alpha=2e2).as_f32()
    single = register(jnp.asarray(fixed), jnp.asarray(moving), params, config)

    mesh = make_mesh(4, 2)
    run = make_sharded_register(mesh, config)
    sharded = jax.block_until_ready(
        run(jnp.asarray(fixed), jnp.asarray(moving), params))

    q_err = qmul(sharded.q, qconj(single.q))
    assert float(qangle_deg(q_err)) < 5e-3
    np.testing.assert_allclose(np.asarray(sharded.t), np.asarray(single.t),
                               atol=0.1)


def test_sharded_plane_objective(pair):
    """Sharded point-to-plane matches single-device plane registration."""
    from icp_tpu import Objective

    fixed, moving, q_true, t_true = pair
    config = ICPConfig(m=4096, n_r=64, objective=Objective.PLANE,
                       estimate_scale=False,
                       correspondence=Correspondence.RBC)
    params = ICPParams(alpha=2e2).as_f32()
    single = register(jnp.asarray(fixed), jnp.asarray(moving), params, config)

    mesh = make_mesh(4, 2)
    run = make_sharded_register(mesh, config)
    sharded = jax.block_until_ready(
        run(jnp.asarray(fixed), jnp.asarray(moving), params))
    q_err = qmul(sharded.q, qconj(single.q))
    # Looser than the POINT-mode comparison: NN tie-breaking differs between
    # the sharded and single-device search paths, and the plane solve is
    # sensitive to individual pair swaps; both land equally near the truth.
    assert float(qangle_deg(q_err)) < 0.02
    np.testing.assert_allclose(np.asarray(sharded.t), np.asarray(single.t),
                               atol=0.3)
    _check(sharded, q_true, t_true)


def test_sharded_brute_mode(pair):
    fixed, moving, q_true, t_true = pair
    config = ICPConfig(m=4096, n_r=64, rotation=RotationMode.SVD,
                       weighting=Weighting.REGULAR,
                       correspondence=Correspondence.BRUTE)
    mesh = make_mesh(8, 1)
    run = make_sharded_register(mesh, config)
    state = jax.block_until_ready(
        run(jnp.asarray(fixed), jnp.asarray(moving), ICPParams().as_f32()))
    _check(state, q_true, t_true)


def test_masked_median_sharded_matches_global():
    """Distributed quantile (local-median bracket + histogram psum) vs the
    single-array masked median, over a (4, 2) mesh with uneven masks."""
    from functools import partial

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from icp_tpu.ops.moments import masked_median, masked_median_sharded
    from icp_tpu.parallel.mesh import DP_AXIS, MP_AXIS

    rng = np.random.default_rng(3)
    n = 8192
    # Lognormal-ish residual population with a gross-outlier tail, plus a
    # structured mask (shards see systematically different slices).
    x = (rng.gamma(2.0, 5.0, n) ** 1.5).astype(np.float32)
    x[rng.choice(n, n // 10, replace=False)] *= 100.0
    mask = (rng.uniform(size=n) < 0.8)
    mask[: n // 16] = False  # one dp shard loses half its slice

    mesh = make_mesh(4, 2)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DP_AXIS), P(DP_AXIS)), out_specs=P(),
             check_vma=False)
    def dist_med(xl, ml):
        return masked_median_sharded(xl, ml, (DP_AXIS, MP_AXIS))

    got = float(dist_med(jnp.asarray(x), jnp.asarray(mask)))
    want = float(masked_median(jnp.asarray(x), jnp.asarray(mask)))
    # Resolution bound: the histogram bins span the local-median spread.
    assert abs(got - want) <= max(0.02 * want, 1e-3), (got, want)

    # All-masked-out population -> 0 (the adaptive delta then floors).
    zeros = float(dist_med(jnp.asarray(x), jnp.zeros(n, bool)))
    assert zeros == 0.0


def test_masked_median_sharded_exact_when_degenerate():
    """All shards holding identical slices -> local medians agree -> the
    distributed median returns the exact shared element."""
    from functools import partial

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from icp_tpu.ops.moments import masked_median, masked_median_sharded
    from icp_tpu.parallel.mesh import DP_AXIS, MP_AXIS

    rng = np.random.default_rng(4)
    tile = rng.uniform(0, 50, 512).astype(np.float32)
    x = np.tile(tile, 8)  # every dp shard sees the same values
    mesh = make_mesh(8, 1)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DP_AXIS),), out_specs=P(), check_vma=False)
    def dist_med(xl):
        return masked_median_sharded(xl, None, (DP_AXIS, MP_AXIS))

    got = float(dist_med(jnp.asarray(x)))
    want = float(masked_median(jnp.asarray(tile), None))
    assert got == want, (got, want)


def test_sharded_robust_adaptive_recovers_contamination(pair):
    """12%-gross-outlier pair on the sharded path with robust_adaptive:
    the distributed residual median must gate the outliers exactly like
    the single-device adaptive path (which is dragged off the truth
    without a robust kernel)."""
    from icp_tpu import Objective, RobustKernel
    from tests.test_robust import _contaminate

    fixed, moving, q_true, t_true = pair
    rng = np.random.default_rng(7)
    dirty = _contaminate(rng, moving)
    config = ICPConfig(m=4096, n_r=64, rotation=RotationMode.POWER,
                       weighting=Weighting.REGULAR,
                       robust=RobustKernel.TRIMMED, robust_adaptive=True,
                       estimate_scale=False,
                       correspondence=Correspondence.RBC)
    params = ICPParams(alpha=2e2).as_f32()
    single = register(jnp.asarray(fixed), jnp.asarray(dirty), params, config)

    mesh = make_mesh(4, 2)
    run = make_sharded_register(mesh, config)
    sharded = jax.block_until_ready(
        run(jnp.asarray(fixed), jnp.asarray(dirty), params))

    # Both land on the truth...
    for st in (single, sharded):
        q_err = qmul(st.q, qconj(jnp.asarray(q_true)))
        assert float(qangle_deg(q_err)) < 0.1
        np.testing.assert_allclose(np.asarray(st.t), t_true, atol=1.5)
    # ...and agree with each other (loose: the distributed median is a
    # histogram estimate, so trim decisions at the threshold may differ).
    q_err = qmul(sharded.q, qconj(single.q))
    assert float(qangle_deg(q_err)) < 0.05
    np.testing.assert_allclose(np.asarray(sharded.t), np.asarray(single.t),
                               atol=0.5)
