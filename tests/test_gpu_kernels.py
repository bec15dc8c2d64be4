"""The GPU search kernels (icp_tpu.kernels) against their XLA twins.

On the CPU the kernels run in the Pallas interpreter; the ``gpu``-marked
tests compile them for the card and skip elsewhere
(``ICP_TEST_DEVICE=gpu python -m pytest -m gpu tests/`` on a GPU host;
chip_smoke.py runs them too). Random inputs keep the float64 best and
second-best scores far apart, so kernel, twin and float64 must agree
exactly on ids; the tie tests pin the first-minimum rule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu.kernels import kernel_mode, on_gpu
from icp_tpu.kernels.bin_nn import bin_nn
from icp_tpu.kernels.rep_assign import rep_assign_counts
from icp_tpu.rbc.fused_point import bin_nn_ref, rep_assign_counts_ref

rep_assign_i = functools.partial(rep_assign_counts, interpret=True)
bin_nn_i = functools.partial(bin_nn, interpret=True)


def _assign_inputs(rng, m, n_r):
    p = rng.normal(size=(m, 8)).astype(np.float32) * 100
    C = rng.normal(size=(8, n_r)).astype(np.float32)
    srow = rng.normal(size=(1, n_r)).astype(np.float32) * 100
    return p, C, srow


def _assign_f64(p, C, srow):
    return np.argmin(srow.astype(np.float64) - 2.0 * p.astype(np.float64)
                     @ C.astype(np.float64), axis=1)


def _nn_inputs(rng, n_r, cq, cb, invalid=0.2):
    q = rng.normal(size=(n_r, cq, 8)).astype(np.float32) * 30
    b = rng.normal(size=(n_r, cb, 8)).astype(np.float32) * 30
    sq = rng.uniform(0, 2000, size=(n_r, cb)).astype(np.float32)
    sq[rng.uniform(size=(n_r, cb)) < invalid] = np.inf
    return q, b, sq


def _nn_f64(q, b, sq):
    s = sq[:, None, :].astype(np.float64) - 2.0 * np.einsum(
        "bqk,bck->bqc", q.astype(np.float64), b.astype(np.float64))
    return np.argmin(s, axis=-1), np.min(s, axis=-1)


# ---------------------------------------------------------------------------
# rep_assign
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n_r", [(300, 100), (64, 4), (1000, 256),
                                   (17, 70), (1, 64), (200, 96), (96, 200)])
def test_rep_assign_matches_twin_and_f64(rng, m, n_r):
    """Shapes that are and are not whole tiles on both axes, one and many
    tiles each."""
    p, C, srow = _assign_inputs(rng, m, n_r)
    rid, counts = rep_assign_i(jnp.asarray(p), jnp.asarray(C),
                               jnp.asarray(srow))
    rid_t, counts_t = rep_assign_counts_ref(jnp.asarray(p), jnp.asarray(C),
                                            jnp.asarray(srow))
    np.testing.assert_array_equal(np.asarray(rid), _assign_f64(p, C, srow))
    np.testing.assert_array_equal(np.asarray(rid), np.asarray(rid_t))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(counts_t))


def test_rep_assign_exact_ties_take_first(rng):
    """Duplicate representatives tie exactly, within a tile and across
    tiles: the smallest id wins, as jnp.argmin's does."""
    p, C, srow = _assign_inputs(rng, 128, 160)
    C[:, 100] = C[:, 3]
    srow[0, 100] = srow[0, 3]
    C[:, 5] = C[:, 4]
    srow[0, 5] = srow[0, 4]
    srow[0, [3, 4]] -= 1e6  # make the tied pairs the winners
    rid, _ = rep_assign_i(jnp.asarray(p), jnp.asarray(C), jnp.asarray(srow))
    rid = np.asarray(rid)
    assert set(np.unique(rid)) <= {3, 4}
    np.testing.assert_array_equal(
        rid, np.asarray(rep_assign_counts_ref(
            jnp.asarray(p), jnp.asarray(C), jnp.asarray(srow))[0]))


@pytest.mark.parametrize("m,n_r,skew", [(333, 64, False), (4096, 256, False),
                                        (500, 32, True)])
def test_rep_assign_counts_exact(rng, m, n_r, skew):
    """counts == bincount(ids) exactly, padding rows counted nowhere, also
    when every query lands in one bin."""
    p, C, srow = _assign_inputs(rng, m, n_r)
    if skew:
        srow[0, 7] -= 1e7
    rid, counts = rep_assign_i(jnp.asarray(p), jnp.asarray(C),
                               jnp.asarray(srow))
    rid, counts = np.asarray(rid), np.asarray(counts)
    assert counts.dtype == np.int32 and counts.sum() == m
    np.testing.assert_array_equal(counts, np.bincount(rid, minlength=n_r))
    if skew:
        assert counts[7] == m


def test_rep_assign_rejects_bad_shapes(rng):
    p, C, srow = _assign_inputs(rng, 64, 16)
    with pytest.raises(ValueError):
        rep_assign_i(jnp.asarray(p[:, :6]), jnp.asarray(C), jnp.asarray(srow))
    with pytest.raises(ValueError):
        rep_assign_i(jnp.asarray(p), jnp.asarray(C), jnp.asarray(srow[:, :8]))


def test_rep_assign_under_vmap(rng):
    """register_batch vmaps the pipeline: the kernel must batch."""
    p = np.stack([_assign_inputs(rng, 96, 40)[0] for _ in range(3)])
    _, C, srow = _assign_inputs(rng, 96, 40)
    rid, counts = jax.vmap(lambda x: rep_assign_i(
        x, jnp.asarray(C), jnp.asarray(srow)))(jnp.asarray(p))
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(rid[i]),
                                      _assign_f64(p[i], C, srow))
        np.testing.assert_array_equal(
            np.asarray(counts[i]),
            np.bincount(np.asarray(rid[i]), minlength=40))


# ---------------------------------------------------------------------------
# bin_nn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_r,cq,cb", [(5, 24, 100), (3, 96, 128),
                                       (4, 40, 33), (2, 8, 256),
                                       (3, 32, 200), (2, 3, 31)])
def test_bin_nn_matches_twin_and_f64(rng, n_r, cq, cb):
    """cq not a multiple of the query tile, cb not a multiple of the
    candidate tile, +inf slots scattered through the bins."""
    q, b, sq = _nn_inputs(rng, n_r, cq, cb)
    slot, score = bin_nn_i(jnp.asarray(q), jnp.asarray(b), jnp.asarray(sq))
    slot_t, score_t = bin_nn_ref(jnp.asarray(q), jnp.asarray(b),
                                 jnp.asarray(sq))
    slot64, score64 = _nn_f64(q, b, sq)
    np.testing.assert_array_equal(np.asarray(slot), slot64)
    np.testing.assert_array_equal(np.asarray(slot), np.asarray(slot_t))
    np.testing.assert_allclose(np.asarray(score), score64, rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(score), np.asarray(score_t),
                               rtol=1e-4, atol=0.5)


def test_bin_nn_empty_and_all_invalid_bins(rng):
    """A bin with no valid slot yields slot 0 and +inf, like the twin."""
    q, b, sq = _nn_inputs(rng, 6, 16, 64)
    sq[1] = np.inf
    sq[4] = np.inf
    slot, score = bin_nn_i(jnp.asarray(q), jnp.asarray(b), jnp.asarray(sq))
    slot_t, score_t = bin_nn_ref(jnp.asarray(q), jnp.asarray(b),
                                 jnp.asarray(sq))
    slot, score = np.asarray(slot), np.asarray(score)
    for r in (1, 4):
        assert np.all(slot[r] == 0) and np.all(np.isinf(score[r]))
    np.testing.assert_array_equal(slot, np.asarray(slot_t))
    np.testing.assert_array_equal(np.isinf(score),
                                  np.isinf(np.asarray(score_t)))


def test_bin_nn_single_valid_slot(rng):
    """Only the last slot of the last tile is valid: every query takes it."""
    q, b, sq = _nn_inputs(rng, 3, 24, 96, invalid=0.0)
    sq[:, :-1] = np.inf
    slot, score = bin_nn_i(jnp.asarray(q), jnp.asarray(b), jnp.asarray(sq))
    assert np.all(np.asarray(slot) == 95)
    assert np.all(np.isfinite(np.asarray(score)))


def test_bin_nn_exact_ties_take_first(rng):
    """Duplicate bin points tie exactly; the smallest slot wins, within a
    candidate tile and across tiles."""
    q, b, sq = _nn_inputs(rng, 2, 16, 80, invalid=0.0)
    b[:, 70] = b[:, 2]
    sq[:, 70] = sq[:, 2]
    b[:, 3] = b[:, 2]
    sq[:, 3] = sq[:, 2]
    sq[:, 2] -= 1e6
    sq[:, 3] -= 1e6
    sq[:, 70] -= 1e6
    slot, _ = bin_nn_i(jnp.asarray(q), jnp.asarray(b), jnp.asarray(sq))
    slot_t, _ = bin_nn_ref(jnp.asarray(q), jnp.asarray(b), jnp.asarray(sq))
    assert np.all(np.asarray(slot) == 2)
    np.testing.assert_array_equal(np.asarray(slot), np.asarray(slot_t))


def test_bin_nn_rejects_bad_shapes(rng):
    q, b, sq = _nn_inputs(rng, 3, 16, 32)
    with pytest.raises(ValueError):
        bin_nn_i(jnp.asarray(q[..., :6]), jnp.asarray(b), jnp.asarray(sq))
    with pytest.raises(ValueError):
        bin_nn_i(jnp.asarray(q), jnp.asarray(b), jnp.asarray(sq[:, :31]))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_kernel_mode_selects_twin_or_interpreter():
    calls = []

    def kernel(x, interpret=False):
        calls.append(("kernel", interpret))
        return x + 1

    def twin(x):
        calls.append(("twin",))
        return x + 1

    x = jnp.zeros(3)
    on_gpu("k", kernel, twin, x)
    with kernel_mode("xla"):
        on_gpu("k", kernel, twin, x)
    with kernel_mode("interpret"):
        on_gpu("k", kernel, twin, x)
    with kernel_mode("interpret", only=("other",)):
        on_gpu("k", kernel, twin, x)
    assert calls == [("twin",), ("twin",), ("kernel", True), ("twin",)]
    with pytest.raises(ValueError):
        with kernel_mode("fast"):
            pass


def test_register_interpreted_kernels_match_twins(rng):
    """A whole jitted registration with the interpreted kernels lands
    where the one with the twins does (PLANE: a sharp optimum)."""
    from icp_tpu import ICPConfig, ICPParams, Objective
    from icp_tpu.icp.run import register
    from icp_tpu.sensors.synthetic import wavy_surface_pair

    fixed, moving, _q, _t = wavy_surface_pair(4096)
    cfg = ICPConfig(m=4096, n_r=64, objective=Objective.PLANE,
                    normal_mode="knn", estimate_scale=False)
    params = ICPParams(alpha=2e2).as_f32()
    out = {}
    for mode in ("interpret", "xla"):
        with kernel_mode(mode):
            fn = jax.jit(lambda f, m, p: register.__wrapped__(f, m, p, cfg))
            out[mode] = fn(jnp.asarray(fixed), jnp.asarray(moving), params)
    np.testing.assert_allclose(np.asarray(out["interpret"].t),
                               np.asarray(out["xla"].t), atol=1e-3)
    np.testing.assert_allclose(np.asarray(out["interpret"].q),
                               np.asarray(out["xla"].q), atol=1e-6)


@pytest.mark.parametrize("mode", ["point", "plane"])
def test_adaptive_robust_interpreted_kernels_match_twins(rng, mode):
    """The adaptive-robust first pass (distance-only search) and the
    moment pass, through rbc_point_moments / rbc_gn_system."""
    from icp_tpu.icp.state import identity_state
    from icp_tpu.ops.normals import normals_for
    from icp_tpu.rbc.construct import rbc_construct
    from icp_tpu.rbc.search import rbc_gn_system, rbc_point_moments
    from tests.utils import make_cloud8, random_quat

    db = make_cloud8(rng, 512)
    reps = db[rng.choice(512, 16, replace=False)]
    normals = normals_for(jnp.asarray(db), "knn") if mode == "plane" else None
    idx = rbc_construct(jnp.asarray(db), jnp.asarray(reps),
                        jnp.float32(150.0), 64, normals=normals)
    moving = jnp.asarray(make_cloud8(rng, 512))
    st = identity_state()._replace(
        q=jnp.asarray(random_quat(rng, 0.05)),
        t=jnp.asarray((rng.normal(size=3) * 10).astype(np.float32)))
    kw = dict(weighted=False, robust="tukey", robust_delta=1e9,
              robust_adaptive=True)

    def run():
        if mode == "point":
            return rbc_point_moments(idx, moving, st.q, st.t, st.s,
                                     jnp.float32(150.0), jnp.float32(1e-6),
                                     64, **kw)
        return (rbc_gn_system(idx, moving, st.q, st.t, st.s,
                              jnp.float32(150.0), 64, mode="plane", **kw),)

    with kernel_mode("interpret"):
        got = run()
    want = run()
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=1e-4 * max(np.abs(b).max(), 1))


# ---------------------------------------------------------------------------
# On the card (skip elsewhere)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m,n_r", [(300, 100), (16384, 256),
                                   (262144, 2048)])
def test_rep_assign_compiled_on_card(gpu, rng, m, n_r):
    p, C, srow = _assign_inputs(rng, m, n_r)
    rid, counts = rep_assign_counts(jnp.asarray(p), jnp.asarray(C),
                                    jnp.asarray(srow))
    rid = np.asarray(rid)
    ref = _assign_f64(p, C, srow)
    assert np.mean(rid == ref) > 0.9999
    np.testing.assert_array_equal(np.asarray(counts),
                                  np.bincount(rid, minlength=n_r))


@pytest.mark.gpu
@pytest.mark.parametrize("n_r,cq,cb", [(5, 24, 100), (256, 96, 128),
                                       (2048, 192, 256)])
def test_bin_nn_compiled_on_card(gpu, rng, n_r, cq, cb):
    q, b, sq = _nn_inputs(rng, n_r, cq, cb)
    sq[0] = np.inf  # an empty bin
    slot, score = bin_nn(jnp.asarray(q), jnp.asarray(b), jnp.asarray(sq))
    slot64, score64 = _nn_f64(q, b, sq)
    assert np.mean(np.asarray(slot) == slot64) > 0.9999
    fin = np.isfinite(score64)
    np.testing.assert_array_equal(np.isfinite(np.asarray(score)), fin)
    np.testing.assert_allclose(np.asarray(score)[fin], score64[fin],
                               rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_platform_dependent_picks_kernel_on_card(gpu, rng):
    """Under jit on the card on_gpu lowers the Triton kernel: its ids are
    the float64 ones even where the bf16x3 twin rounds differently."""
    from icp_tpu.rbc.fused_point import rep_assign_counts as dispatch

    p, C, srow = _assign_inputs(rng, 4096, 256)
    rid, _ = jax.jit(dispatch)(jnp.asarray(p), jnp.asarray(C),
                               jnp.asarray(srow))
    text = jax.jit(dispatch).lower(jnp.asarray(p), jnp.asarray(C),
                                   jnp.asarray(srow)).as_text()
    assert "rep_assign" in text
    np.testing.assert_array_equal(np.asarray(rid), _assign_f64(p, C, srow))
