"""Per-op golden tests vs numpy references, mirroring the reference's
tiered-tolerance discipline (SURVEY.md §4: exact for samplers, 42*eps
per-element, 4200*eps for 16k sums, 420000*eps for means over 16k)."""

import numpy as np
import jax.numpy as jnp

from icp_tpu.ops import distance, moments, reduce as red, sampling, scan
from tests import goldens
from tests.utils import FLOAT_EPS, make_cloud8


# --- samplers (exact equality, like testsICP.cpp:104-106) -------------------

def test_get_landmarks_exact(rng):
    cloud = make_cloud8(rng, 640 * 480).reshape(480, 640, 8)
    ref = goldens.golden_get_landmarks(cloud)
    got = np.asarray(sampling.get_landmarks(jnp.asarray(cloud)))
    np.testing.assert_array_equal(got, ref)


def test_get_reps_exact(rng):
    lms = make_cloud8(rng, 16384)
    for n_ry, n_rx in [(16, 16), (8, 16), (4, 8)]:
        ref = goldens.golden_get_reps(lms, n_ry, n_rx)
        got = np.asarray(sampling.get_representatives(jnp.asarray(lms), n_ry, n_rx))
        np.testing.assert_array_equal(got, ref)


def test_representative_landmark_indices(rng):
    lms = make_cloud8(rng, 16384)
    idx = np.asarray(sampling.representative_landmark_indices(16, 16))
    reps = np.asarray(sampling.get_representatives(jnp.asarray(lms), 16, 16))
    np.testing.assert_array_equal(lms[idx], reps)


# --- weights (42*eps/element, 4200*eps sum; testsICP.cpp:282-284) -----------

def test_weights(rng):
    d = rng.uniform(0, 10000, 16384).astype(np.float32)
    ref_w, ref_sw = goldens.golden_weights(d)
    w = moments.compute_weights(jnp.asarray(d))
    sw = moments.masked_weight_sum(w)
    np.testing.assert_allclose(np.asarray(w), ref_w, atol=42 * FLOAT_EPS)
    assert abs(float(sw) - ref_sw) < 4200 * FLOAT_EPS * ref_sw


# --- means (420000*eps over 16k; testsICP.cpp:369) --------------------------

def test_means_regular(rng):
    F = make_cloud8(rng, 16384)
    M = make_cloud8(rng, 16384)
    ref_f, ref_m = goldens.golden_means(F, M)
    mf, mm = moments.centroids(jnp.asarray(F), jnp.asarray(M))
    tol = 420000 * FLOAT_EPS  # ~0.05 on mm-scale data
    np.testing.assert_allclose(np.asarray(mf), ref_f, atol=tol * 100)
    np.testing.assert_allclose(np.asarray(mm), ref_m, atol=tol * 100)


def test_means_weighted(rng):
    F = make_cloud8(rng, 4096)
    M = make_cloud8(rng, 4096)
    W = rng.uniform(0.1, 1.0, 4096).astype(np.float32)
    sw = W.astype(np.float64).sum()
    ref_f, ref_m = goldens.golden_means_weighted(F, M, W, sw)
    mf, mm = moments.centroids(jnp.asarray(F), jnp.asarray(M),
                               jnp.asarray(W), jnp.float32(sw))
    np.testing.assert_allclose(np.asarray(mf), ref_f, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(mm), ref_m, rtol=1e-4)


def test_means_masked(rng):
    F = make_cloud8(rng, 256)
    M = make_cloud8(rng, 256)
    mask = rng.uniform(size=256) < 0.7
    mf, mm = moments.centroids(jnp.asarray(F), jnp.asarray(M),
                               mask=jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(mf), F[mask, :3].mean(0), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(mm), M[mask, :3].mean(0), rtol=1e-5)


# --- deviations + S matrix (4200*eps for 16k sums; testsICP.cpp:653) --------

def test_deviations(rng):
    F = make_cloud8(rng, 1024)
    mf = F[:, :3].mean(0)
    got = np.asarray(moments.deviations(jnp.asarray(F), jnp.asarray(mf)))
    np.testing.assert_allclose(got, F[:, :3] - mf, atol=1e-4)


def test_s_matrix_regular(rng):
    m = 16384
    F = make_cloud8(rng, m)
    M = make_cloud8(rng, m)
    df = F[:, :3] - F[:, :3].mean(0)
    dm = M[:, :3] - M[:, :3].mean(0)
    c = 1e-6
    ref = goldens.golden_s_matrix(dm, df, c)
    got = np.asarray(moments.s_matrix(jnp.asarray(dm), jnp.asarray(df),
                                      jnp.float32(c)))
    np.testing.assert_allclose(got, ref, atol=4200 * FLOAT_EPS, rtol=1e-4)


def test_s_matrix_weighted(rng):
    m = 4096
    F = make_cloud8(rng, m)
    M = make_cloud8(rng, m)
    W = rng.uniform(0.1, 1.0, m)
    df = F[:, :3] - F[:, :3].mean(0)
    dm = M[:, :3] - M[:, :3].mean(0)
    c = 1e-6
    ref = goldens.golden_s_matrix(dm, df, c, W)
    got = np.asarray(moments.s_matrix(jnp.asarray(dm), jnp.asarray(df),
                                      jnp.float32(c),
                                      jnp.asarray(W.astype(np.float32))))
    np.testing.assert_allclose(got, ref, atol=4200 * FLOAT_EPS, rtol=1e-4)


def test_s_matrix_masked_equals_subset(rng):
    m = 512
    F = make_cloud8(rng, m)
    M = make_cloud8(rng, m)
    mask = rng.uniform(size=m) < 0.5
    df = F[:, :3] - F[:, :3].mean(0)
    dm = M[:, :3] - M[:, :3].mean(0)
    got = np.asarray(moments.s_matrix(jnp.asarray(dm), jnp.asarray(df),
                                      jnp.float32(1e-3),
                                      mask=jnp.asarray(mask)))
    ref = goldens.golden_s_matrix(dm[mask], df[mask], 1e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


# --- distance ---------------------------------------------------------------

def test_pairwise_blended_distance(rng):
    a = make_cloud8(rng, 32)
    b = make_cloud8(rng, 24)
    alpha = 200.0
    d2 = np.asarray(distance.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b),
                                               jnp.float32(alpha)))
    for i in range(0, 32, 7):
        for j in range(0, 24, 5):
            ref = goldens.golden_blended_d2(a[i], b[j], alpha)
            assert abs(d2[i, j] - ref) < max(1e-2, 1e-5 * ref)


def test_point_sq_dists_matches_pairwise_diag(rng):
    a = make_cloud8(rng, 16)
    b = make_cloud8(rng, 16)
    alpha = 100.0
    full = np.asarray(distance.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b),
                                                 jnp.float32(alpha)))
    diag = np.asarray(distance.point_sq_dists(jnp.asarray(a), jnp.asarray(b),
                                              jnp.float32(alpha)))
    np.testing.assert_allclose(diag, np.diag(full), rtol=1e-4, atol=1e-2)


def test_brute_nn_exact(rng):
    q = make_cloud8(rng, 64)
    db = make_cloud8(rng, 128)
    alpha = 150.0
    idx, d = distance.nearest_neighbor_brute(jnp.asarray(q), jnp.asarray(db),
                                             jnp.float32(alpha))
    for i in range(64):
        ref_d = [goldens.golden_blended_d2(q[i], db[j], alpha) for j in range(128)]
        assert int(idx[i]) == int(np.argmin(ref_d))


# --- reduce / scan parity ops (testsReduce/testsScan equivalents) -----------

def test_reduce_ops(rng):
    x = rng.uniform(0, 1, (4, 1024)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(red.reduce_min(jnp.asarray(x))), x.min(1))
    np.testing.assert_allclose(np.asarray(red.reduce_max(jnp.asarray(x))), x.max(1))
    np.testing.assert_allclose(np.asarray(red.reduce_sum(jnp.asarray(x))), x.sum(1),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(red.reduce_sum_fd(jnp.asarray(x))),
                               x.astype(np.float64).sum(1), rtol=1e-5)


def test_reduce_sum_fd_compensated_beats_f32(rng):
    """On backends without f64 the compensated path must actually carry the
    low-order bits the reference's double accumulation keeps: an input whose
    naive f32 sum loses ~half the mantissa must come out near-exact."""
    n = 16384
    x = np.full(n, 0.1, np.float32)  # 0.1 is inexact in binary: f32
    x[0] = 1e7                       # accumulation onto 1e7 drops its bits
    want = float(x.astype(np.float64).sum())
    naive = float(jnp.sum(jnp.asarray(x)))  # XLA's plain f32 reduce
    got = float(red._neumaier_sum(jnp.asarray(x), axis=0))
    # Compensation recovers the dropped bits: the result is correct up to
    # the final rounding to f32 (1 ulp at 1e7 is 1.0), while the plain
    # reduce is an order of magnitude off (measured -15.3 vs -0.3 here).
    assert abs(got - want) <= 2 * np.spacing(np.float32(want)), (got, want)
    assert abs(got - want) < abs(naive - want) / 10, (got, naive, want)


def test_scan_ops(rng):
    x = rng.integers(0, 100, (3, 512)).astype(np.int32)
    inc = np.asarray(scan.inclusive_scan(jnp.asarray(x)))
    exc = np.asarray(scan.exclusive_scan(jnp.asarray(x)))
    np.testing.assert_array_equal(inc, np.cumsum(x, 1))
    ref_exc = np.cumsum(x, 1) - x
    np.testing.assert_array_equal(exc, ref_exc)


def test_get_landmarks_numpy_slice_parity(rng):
    """The reference sampling formula (kernels/icp_kernels.cl:62-76,
    landmark[r,l] = cloud[49+3r, 65+4l]) as a host-side numpy strided
    slice is bit-identical to ops.sampling.get_landmarks — bench.py's
    SLAM gate samples keyframes host-side to keep full frames off the
    device."""
    cloud = rng.uniform(0, 1, (480, 640, 8)).astype(np.float32)
    a = np.asarray(sampling.get_landmarks(jnp.asarray(cloud.reshape(-1, 8))))
    b = cloud[49:49 + 384:3, 65:65 + 512:4].reshape(16384, 8)
    assert np.array_equal(a, b)
