"""kNN PCA normal estimation — unlocks PLANE/GICP on UNORGANIZED clouds
(ops.normals.knn_normals; normal_mode="knn"). The organized-grid estimator
cannot run on scattered samples (and "auto" would silently produce garbage
grid normals on a square-sized random cloud — a documented trap).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from icp_tpu import ICPConfig, ICPParams, Objective, register
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.ops.normals import (_smallest_eigvec3, knn_normals,
                                 knn_normals_rbc, normals_for)
from tests.test_icp_e2e import _make_pair, _structured_cloud


def _analytic_normals(cloud8: np.ndarray) -> np.ndarray:
    """Ground-truth normals of the test surface z = 1500 + 80 sin(u/90)
    + 60 cos(v/70): n ∝ (-dz/du, -dz/dv, 1), oriented toward the camera
    (n . p < 0 — the surface is at z ~ 1.5 m, so the -z orientation)."""
    u, v = cloud8[:, 0], cloud8[:, 1]
    dzdu = 80.0 / 90.0 * np.cos(u / 90.0)
    dzdv = -60.0 / 70.0 * np.sin(v / 70.0)
    n = np.stack([dzdu, dzdv, -np.ones_like(u)], -1)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def test_knn_normals_match_analytic(rng):
    cloud = _structured_cloud(rng, 4096)  # RANDOM (u, v) — unorganized
    n_est = np.asarray(knn_normals(jnp.asarray(cloud), k=16))
    n_true = _analytic_normals(cloud)
    cos = np.abs(np.sum(n_est * n_true, axis=-1))
    # PCA over a ~40-mm neighborhood of a gently curved surface: nearly
    # all points within a few degrees; allow a small tail near sparse
    # sampling regions.
    assert np.median(cos) > 0.999
    assert np.mean(cos > 0.99) > 0.95
    # Orientation: toward the camera (n . p < 0).
    assert np.all(np.sum(n_est * cloud[:, :3], axis=-1) <= 1e-3)


def test_knn_normals_invalid_points(rng):
    cloud = _structured_cloud(rng, 512)
    cloud[100:120] = 0.0  # sensor dropouts
    n = np.asarray(knn_normals(jnp.asarray(cloud), k=8, block=256))
    assert np.all(n[100:120] == 0.0)
    valid = np.abs(cloud[:, :3]).sum(-1) > 0
    assert np.all(np.abs(np.linalg.norm(n[valid], axis=-1) - 1.0) < 1e-3)


def test_normals_for_modes(rng):
    cloud = jnp.asarray(_structured_cloud(rng, 1000))  # non-square count
    assert np.all(np.asarray(normals_for(cloud)) == 0.0)  # auto -> zeros
    n = np.asarray(normals_for(cloud, "knn"))
    assert np.abs(np.linalg.norm(n, axis=-1) - 1.0).max() < 1e-3
    with pytest.raises(ValueError, match="square"):
        normals_for(cloud, "grid")
    with pytest.raises(ValueError, match="normal_mode"):
        ICPConfig(normal_mode="pca")


def test_smallest_eigvec3_matches_eigh(rng):
    """The closed-form 3x3 eigensolver (the batched-``eigh`` replacement
    that makes LiDAR-scale normal estimation cheap) must agree with eigh
    on realistic PCA covariances, including near-planar ones."""
    # Random PSD batches with anisotropic spectra like surface patches.
    A = rng.normal(size=(512, 16, 3)).astype(np.float32)
    A[:, :, 2] *= 0.05  # thin along z: planar neighborhoods
    C = np.einsum("bki,bkj->bij", A, A)
    v_cf = np.asarray(_smallest_eigvec3(jnp.asarray(C)))
    _, vecs = np.linalg.eigh(C)
    v_ref = vecs[..., 0]
    cos = np.abs(np.sum(v_cf * v_ref, axis=-1))
    assert np.min(cos) > 0.999, float(np.min(cos))


def test_knn_rbc_matches_analytic(rng):
    """The RBC-accelerated estimator holds the brute estimator's bounds on
    the analytic surface (objective-level equivalence)."""
    cloud = _structured_cloud(rng, 4096)
    n_est = np.asarray(knn_normals_rbc(jnp.asarray(cloud), k=16))
    n_true = _analytic_normals(cloud)
    cos = np.abs(np.sum(n_est * n_true, axis=-1))
    assert np.median(cos) > 0.999
    assert np.mean(cos > 0.99) > 0.95
    assert np.all(np.sum(n_est * cloud[:, :3], axis=-1) <= 1e-3)


def test_knn_rbc_parity_with_brute(rng):
    """Head-to-head at 16384: the overlapping-ball candidate sets must
    reproduce the exact-kNN normals almost everywhere (far-tail neighbor
    swaps move a normal by well under a degree on this surface)."""
    cloud = _structured_cloud(rng, 16384)
    n_b = np.asarray(knn_normals(jnp.asarray(cloud), k=16))
    n_r = np.asarray(knn_normals_rbc(jnp.asarray(cloud), k=16))
    # Overflowed queries fall back to zero normals; they must be rare.
    zero = np.linalg.norm(n_r, axis=-1) < 0.5
    assert np.mean(zero) < 0.02, float(np.mean(zero))
    cos = np.abs(np.sum(n_b * n_r, axis=-1))[~zero]
    assert np.mean(cos > 0.999) > 0.97, float(np.mean(cos > 0.999))
    assert np.median(cos) > 0.9999


def test_knn_rbc_invalid_points(rng):
    cloud = _structured_cloud(rng, 2048)
    cloud[100:120] = 0.0  # sensor dropouts
    n = np.asarray(knn_normals_rbc(jnp.asarray(cloud), k=8))
    assert np.all(n[100:120] == 0.0)
    valid = np.abs(cloud[:, :3]).sum(-1) > 0
    nv = n[valid]
    nz = np.linalg.norm(nv, axis=-1) > 0.5  # overflow slots excepted
    assert np.all(np.abs(np.linalg.norm(nv[nz], axis=-1) - 1.0) < 1e-3)


def test_knn_moments_kernel_parity(rng):
    """The per-bin kNN covariances (bisection on the k-th distance value,
    masked products) == a float64 numpy kNN covariance per query,
    including underfull and NaN-encoded invalid candidates."""
    import jax.numpy as jnp

    from icp_tpu.ops.normals import bin_knn_moments

    n_r, cq, cb, k = 8, 16, 128, 12
    reps = rng.normal(size=(n_r, 3)).astype(np.float32) * 100
    qp = reps[:, None, :] + rng.normal(
        size=(n_r, cq, 3)).astype(np.float32) * 40
    bins = reps[:, None, :] + rng.normal(
        size=(n_r, cb, 3)).astype(np.float32) * 40
    # Invalidate a varying tail per bin (some bins underfull vs k), plus
    # a few NaN-encoded invalid points inside the valid span.
    bvalid = np.ones((n_r, cb), bool)
    for r in range(n_r):
        n_valid = int(rng.integers(4, cb))
        bvalid[r, n_valid:] = False
    bins[2, 1] = np.nan
    comps = bin_knn_moments(*map(jnp.asarray, (qp, bins, reps, bvalid)),
                            k=k, chunk=4)
    got = np.stack([np.asarray(c) for c in comps], -1)  # (n_r, cq, 6)
    assert np.all(np.isfinite(got))
    ok = bvalid & np.isfinite(bins).all(-1)
    for r in range(n_r):
        cand = bins[r][ok[r]].astype(np.float64)
        for i in range(cq):
            d = ((cand - qp[r, i]) ** 2).sum(-1)
            nb = cand[np.argsort(d)[:k]]
            C = (nb - nb.mean(0)).T @ (nb - nb.mean(0))
            want = C[[0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
            np.testing.assert_allclose(got[r, i], want, rtol=1e-3,
                                       atol=1e-2 * np.abs(C).max())


def test_rep_top2_kernel_parity(rng):
    """The nearest-representatives strip of knn_normals_rbc against a
    numpy reference: first/second nearest rep ids + exact per-choice
    counts, with a strip-padding tail (m not a multiple of the strip)."""
    from icp_tpu.ops.normals import _nearest_reps

    m, n_r = 2100, 64
    p = rng.normal(size=(m, 3)).astype(np.float32) * 100
    reps = p[rng.choice(m, n_r, replace=False)]
    ids, counts = _nearest_reps(jnp.asarray(p), jnp.asarray(reps), 2)
    d = ((p ** 2).sum(1)[:, None] - 2 * p @ reps.T
         + (reps ** 2).sum(1)[None, :])
    order = np.argsort(d, axis=1)
    np.testing.assert_array_equal(np.asarray(ids[:, 0]), order[:, 0])
    np.testing.assert_array_equal(np.asarray(ids[:, 1]), order[:, 1])
    np.testing.assert_array_equal(
        np.asarray(counts[0]), np.bincount(order[:, 0], minlength=n_r))
    np.testing.assert_array_equal(
        np.asarray(counts[1]), np.bincount(order[:, 1], minlength=n_r))


def test_plane_knn_rbc_registers_unorganized(rng):
    """PLANE with the RBC normal estimator recovers the truth on an
    unorganized pair — the LiDAR-scale path end to end."""
    fixed, moving, q_true, t_true = _make_pair(rng, 4096)
    config = ICPConfig(m=4096, n_r=64, objective=Objective.PLANE,
                       normal_mode="knn_rbc", estimate_scale=False)
    st = register(jnp.asarray(fixed), jnp.asarray(moving),
                  ICPParams(alpha=2e2).as_f32(), config)
    assert np.linalg.norm(np.asarray(st.t) - t_true) < 0.5
    assert float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q_true))))) < 0.05


def test_plane_knn_registers_unorganized(rng):
    """PLANE on an unorganized pair with knn normals recovers the truth —
    the capability the grid estimator cannot provide."""
    fixed, moving, q_true, t_true = _make_pair(rng, 4096)
    config = ICPConfig(m=4096, n_r=64, objective=Objective.PLANE,
                       normal_mode="knn", estimate_scale=False)
    st = register(jnp.asarray(fixed), jnp.asarray(moving),
                  ICPParams(alpha=2e2).as_f32(), config)
    assert np.linalg.norm(np.asarray(st.t) - t_true) < 0.5
    assert float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q_true))))) < 0.05
