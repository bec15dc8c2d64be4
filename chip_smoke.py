"""Smoke test of icp_tpu on one NVIDIA GPU, through the public entry points.

    python chip_smoke.py          # one card: phases a-e
    python chip_smoke.py --four   # four cards: sharded registration only

Phases (one card):
  a. flagship POINT ``register`` (16384 landmarks, 256 representatives) on
     a rendered ground-truth pair: accuracy and ms/iteration;
  b. PLANE, symmetric PLANE and GICP ``register`` on the same pair;
  c. the 100-frame real-terrain odometry chain (``odometry_chain_device``,
     GICP, 8 iterations per frame): ATE, RPE(10) and frames/s;
  d. the 16x shape (262144 points, 2048 representatives): POINT
     ``register`` on ``wavy_surface_pair`` and LiDAR PLANE with kNN
     normals: accuracy, ms/iteration and the normals' time;
  e. each GPU kernel against its XLA twin at the flagship and 16x widths,
     and ``register`` with the kernels against ``register`` with the twins
     (results and ms/iteration), then the ``gpu``-marked tests.

Times are medians of 5 runs after a warm-up compile. ms/iteration is the
marginal cost (T(40 iterations) - T(8 iterations)) / 32 with convergence
thresholds at zero. Every bound that fails, and every exception, exits
non-zero; the last line is the JSON verdict only when all phases passed.
Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

K_HI, K_LO = 40, 8
RUNS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def report(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def check(phase: str, ok: bool, what: str) -> None:
    if not ok:
        fail(f"phase {phase}: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def median_s(fn, runs: int = RUNS) -> float:
    """Median wall time of ``fn()`` (device work included), after one
    warm-up call that compiles."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def pose_errors(st, q_gt, t_gt):
    import jax.numpy as jnp

    from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul

    t_err = float(jnp.linalg.norm(st.t - jnp.asarray(t_gt)))
    a_err = float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q_gt)))))
    return t_err, a_err


def register_with(mode: str, only=None):
    """A fresh jitted ``register`` traced under ``kernel_mode(mode,
    only)``: "auto" uses the GPU kernels, "xla" their twins."""
    import jax

    from icp_tpu.icp.run import register
    from icp_tpu.kernels import kernel_mode

    raw = register.__wrapped__
    compiled = {}

    def run(fixed, moving, params, config):
        key = config
        if key not in compiled:
            fn = jax.jit(lambda f, m, p: raw(f, m, p, config))
            with kernel_mode(mode, only):
                jax.block_until_ready(fn(fixed, moving, params))
            compiled[key] = fn
        return compiled[key](fixed, moving, params)

    return run


def ms_per_iteration(reg, fixed, moving, config) -> float:
    import dataclasses

    from icp_tpu import ICPParams

    zero = ICPParams(alpha=2e2, angle_threshold_deg=0.0,
                     translation_threshold=0.0).as_f32()
    t = {}
    for k in (K_HI, K_LO):
        cfg = dataclasses.replace(config, max_iterations=k)
        st = reg(fixed, moving, zero, cfg)
        if int(st.k) != k:
            fail(f"zero-threshold run stopped at k={int(st.k)}, not {k}")
        t[k] = median_s(lambda: reg(fixed, moving, zero, cfg))
    return (t[K_HI] - t[K_LO]) / (K_HI - K_LO) * 1e3


def rendered_pair():
    """The rendered ground-truth pair: default scene from the identity
    camera and from a camera moved by (0.46 deg yaw, (10, -6, 8) mm)."""
    import jax.numpy as jnp

    from icp_tpu.ops.sampling import get_landmarks
    from icp_tpu.sensors import synthetic
    from icp_tpu.slam import se3

    scene = synthetic.default_scene()
    q_gt = np.array([0, np.sin(0.004), 0, np.cos(0.004)], np.float32)
    t_gt = np.array([10.0, -6.0, 8.0], np.float32)
    pose_b = synthetic.CameraPose(jnp.asarray(q_gt), jnp.asarray(t_gt))
    la = get_landmarks(synthetic.render_cloud(
        scene, synthetic.CameraPose.identity()).reshape(-1, 8))
    lb = get_landmarks(synthetic.render_cloud(scene, pose_b).reshape(-1, 8))
    rel = se3.relative(synthetic.CameraPose.identity(), pose_b)
    return la, lb, np.asarray(rel.q), np.asarray(rel.t)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_a(pair, reg, config):
    from icp_tpu import ICPParams

    la, lb, q_gt, t_gt = pair
    st = reg(la, lb, ICPParams(alpha=2e2).as_f32(), config)
    t_err, a_err = pose_errors(st, q_gt, t_gt)
    ms = ms_per_iteration(reg, la, lb, config)
    report("a", what="flagship POINT register, rendered pair",
           t_err_mm=t_err, ang_err_deg=a_err, k=int(st.k),
           ms_per_iteration=ms)
    # POINT matches sampled points to sampled points, so it floors at the
    # landmark lattice: ~2.2 mm / ~0.16 deg on this pair. PLANE and GICP
    # (phase b) remove that bias.
    check("a", t_err < 5.0 and a_err < 0.3,
          f"POINT error {t_err:.4f} mm / {a_err:.5f} deg above 5 mm / 0.3 deg")
    return ms


def phase_b(pair, reg, base):
    import dataclasses

    from icp_tpu import ICPParams, Objective

    la, lb, q_gt, t_gt = pair
    variants = {
        "plane": dict(objective=Objective.PLANE),
        "plane_sym": dict(objective=Objective.PLANE, plane_symmetric=True),
        "gicp": dict(objective=Objective.GICP),
    }
    for name, kw in variants.items():
        cfg = dataclasses.replace(base, estimate_scale=False, **kw)
        st = reg(la, lb, ICPParams(alpha=2e2).as_f32(), cfg)
        t_err, a_err = pose_errors(st, q_gt, t_gt)
        report("b", what=f"flagship {name} register, rendered pair",
               t_err_mm=t_err, ang_err_deg=a_err, k=int(st.k))
        check("b", t_err < 1.0 and a_err < 0.05,
              f"{name} error {t_err:.4f} mm / {a_err:.5f} deg")


def phase_c(n_frames: int = 100):
    from concurrent.futures import ThreadPoolExecutor
    from functools import partial

    import jax
    import jax.numpy as jnp

    from icp_tpu import ICPConfig, ICPParams, Objective
    from icp_tpu.ops.sampling import get_landmarks
    from icp_tpu.sensors import realdata, synthetic
    from icp_tpu.slam import se3
    from icp_tpu.slam.odometry import (absolute_trajectory_error,
                                       odometry_chain_device,
                                       relative_pose_error)
    from icp_tpu.slam.se3 import Pose

    poses = synthetic.orbit_trajectory(n_frames, radius_mm=120.0,
                                       yaw_rad=0.12)
    pts, rgb = realdata.terrain_surface()
    t0 = time.perf_counter()
    # Host-side rendering; numpy releases the GIL in its sorts.
    with ThreadPoolExecutor(8) as ex:
        frames = list(ex.map(
            lambda p: realdata.observe(pts, rgb, np.asarray(p.q),
                                       np.asarray(p.t)), poses))
    lms = jnp.stack([get_landmarks(jnp.asarray(f.reshape(-1, 8)))
                     for f in frames])
    t_render = time.perf_counter() - t0
    zero = ICPParams(alpha=2e2, angle_threshold_deg=0.0,
                     translation_threshold=0.0).as_f32()
    config = ICPConfig(max_iterations=8, estimate_scale=False,
                       objective=Objective.GICP)
    chain = jax.jit(partial(odometry_chain_device, params=zero,
                            config=config))
    t_chain = median_s(lambda: chain(lms))
    wq, wt, _ks = chain(lms)
    est = [Pose(np.asarray(wq[i]), np.asarray(wt[i]))
           for i in range(n_frames)]
    gt = [se3.relative(poses[0], p) for p in poses]
    ate = absolute_trajectory_error(est, gt)
    rpe, _ = relative_pose_error(est, gt, delta=10)
    report("c", what=f"{n_frames}-frame terrain odometry chain, GICP x8",
           ate_mm=ate, rpe10_mm=rpe, frames_per_s=n_frames / t_chain,
           chain_s=t_chain, render_s=t_render)
    check("c", ate < 22.0 and rpe < 5.5,
          f"odometry ATE {ate:.3f} mm / RPE(10) {rpe:.3f} mm above 22 / 5.5")


def phase_d(reg, m: int = 262144, n_r: int = 2048):
    import jax
    import jax.numpy as jnp

    from icp_tpu import ICPConfig, ICPParams, Objective
    from icp_tpu.ops.normals import knn_normals_rbc
    from icp_tpu.sensors.synthetic import wavy_surface_pair

    wf, wm, q_gt, t_gt = wavy_surface_pair(m)
    fixed, moving = jnp.asarray(wf), jnp.asarray(wm)
    config = ICPConfig(m=m, n_r=n_r)
    st = reg(fixed, moving, ICPParams(alpha=2e2).as_f32(), config)
    t_err, a_err = pose_errors(st, q_gt, t_gt)
    ms = ms_per_iteration(reg, fixed, moving, config)
    report("d", what=f"POINT register m={m} n_r={n_r}, wavy pair",
           t_err_mm=t_err, ang_err_deg=a_err, k=int(st.k),
           ms_per_iteration=ms)
    check("d", t_err < 1.0 and a_err < 0.05,
          f"{m}-point POINT error {t_err:.4f} mm / {a_err:.5f} deg")

    lidar = ICPConfig(m=m, n_r=n_r, estimate_scale=False,
                      objective=Objective.PLANE, normal_mode="knn")
    st = reg(fixed, moving, ICPParams(alpha=2e2).as_f32(), lidar)
    t_err, a_err = pose_errors(st, q_gt, t_gt)
    normals = jax.jit(knn_normals_rbc)
    knn_ms = median_s(lambda: normals(fixed)) * 1e3
    report("d", what=f"LiDAR PLANE register m={m}, kNN normals",
           t_err_mm=t_err, ang_err_deg=a_err, k=int(st.k),
           knn_normals_ms=knn_ms)
    check("d", t_err < 1.0 and a_err < 0.05,
          f"LiDAR PLANE error {t_err:.4f} mm / {a_err:.5f} deg")
    return fixed, moving, config, ms


def f64_search(scores, terms):
    """float64 argmin over the last axis, and whether it is a near tie:
    the best and second-best scores within 1e-5 of the magnitude of the
    terms they are summed from (the sum of both scores' term magnitudes:
    the scale an f32 comparison of the two rounds at; the quadratic
    expansion cancels, so the scores themselves can be much smaller)."""
    two = np.argpartition(scores, 1, axis=-1)[..., :2]
    s2 = np.take_along_axis(scores, two, axis=-1)
    first = np.argmin(s2, axis=-1)
    best = np.take_along_axis(two, first[..., None], axis=-1)[..., 0]
    gap = np.abs(s2[..., 1] - s2[..., 0])
    mag = np.sum(np.take_along_axis(terms, two, axis=-1), axis=-1)
    return best, ~(gap > 1e-5 * mag), mag


def worst(mask, **cols):
    """Up to 5 rows of diagnostics where ``mask`` holds."""
    idx = np.flatnonzero(mask.reshape(-1))[:5]
    return [{k: float(np.asarray(v).reshape(-1)[i]) for k, v in cols.items()}
            for i in idx]


def kernel_parity(label: str, fixed, moving, config):
    """Each kernel against its twin and float64, on the pipeline's inputs."""
    import jax
    import jax.numpy as jnp

    from icp_tpu import ICPParams
    from icp_tpu.icp.run import build_index
    from icp_tpu.icp.state import identity_state
    from icp_tpu.kernels.bin_nn import bin_nn
    from icp_tpu.kernels.rep_assign import rep_assign_counts
    from icp_tpu.rbc.fused_point import (_search_front, bin_nn_ref,
                                         prep_rep_assign, prep_similarity,
                                         rep_assign_counts_ref)
    from icp_tpu.rbc.grouping import group_rows_by_bin

    params = ICPParams(alpha=2e2).as_f32()
    index = build_index(fixed, params, config)
    st = identity_state()
    G, b_row = prep_similarity(st.q, st.t, st.s)
    C, srow = prep_rep_assign(index.reps, params.alpha, G, b_row)
    rid_k, cnt_k = jax.jit(rep_assign_counts)(moving, C, srow)
    with jax.default_matmul_precision("highest"):
        rid_t, cnt_t = jax.jit(rep_assign_counts_ref)(moving, C, srow)
    rid_k, rid_t = np.asarray(rid_k), np.asarray(rid_t)
    p64, C64 = np.asarray(moving, np.float64), np.asarray(C, np.float64)
    sr64 = np.asarray(srow, np.float64).reshape(1, -1)
    rid64 = np.zeros_like(rid_k)
    tie = np.zeros(rid_k.shape, bool)
    gap_k = np.zeros(rid_k.shape)
    mag = np.zeros(rid_k.shape)
    for lo in range(0, p64.shape[0], 16384):  # bound the f64 scores
        sl = slice(lo, lo + 16384)
        sc = sr64 - 2.0 * p64[sl] @ C64
        rid64[sl], tie[sl], mag[sl] = f64_search(
            sc, np.abs(sr64) + 2.0 * np.abs(p64[sl]) @ np.abs(C64))
        rows = np.arange(sc.shape[0])
        gap_k[sl] = sc[rows, rid_k[sl]] - sc[rows, rid64[sl]]
    n_r = C.shape[1]
    cnt_ok = (np.array_equal(np.asarray(cnt_k),
                             np.bincount(rid_k, minlength=n_r))
              and np.array_equal(np.asarray(cnt_t),
                                 np.bincount(rid_t, minlength=n_r)))
    bad_t = (rid_k != rid_t) & ~tie
    bad_64 = (rid_k != rid64) & ~tie
    report("e", what=f"rep_assign kernel vs twin, {label}",
           ids_differ_kernel_twin=int(np.sum(rid_k != rid_t)),
           ids_differ_kernel_f64=int(np.sum(rid_k != rid64)),
           ids_differ_twin_f64=int(np.sum(rid_t != rid64)),
           differ_outside_near_ties=int(np.sum(bad_t | bad_64)),
           near_ties=int(tie.sum()), counts_exact=cnt_ok,
           worst=worst(bad_t | bad_64, row=np.arange(rid_k.size),
                       kernel=rid_k, twin=rid_t, f64=rid64,
                       f64_gap_of_kernel_choice=gap_k, terms=mag))
    check("e", not np.any(bad_t | bad_64) and cnt_ok,
          f"rep_assign parity at {label}")

    gl = group_rows_by_bin(jnp.asarray(rid_k), n_r, config.query_capacity,
                           (moving,), counts=cnt_k)
    qvalid = gl.valid.astype(moving.dtype)
    _qc, qg_w, valid = _search_front(gl.grouped[0], qvalid, index.reps, G,
                                     b_row, params.alpha)
    sl_k, sc_k = jax.jit(bin_nn)(qg_w, index.bins_centered,
                                 index.sq_b_masked)
    with jax.default_matmul_precision("highest"):
        sl_t, sc_t = jax.jit(bin_nn_ref)(qg_w, index.bins_centered,
                                         index.sq_b_masked)
    sl_k, sl_t = np.asarray(sl_k), np.asarray(sl_t)
    sc_k, sc_t = np.asarray(sc_k), np.asarray(sc_t)
    q64 = np.asarray(qg_w, np.float64)
    b64 = np.asarray(index.bins_centered, np.float64)
    sq64 = np.asarray(index.sq_b_masked, np.float64)
    sl64 = np.zeros_like(sl_k)
    tie = np.zeros(sl_k.shape, bool)
    mag = np.ones(sl_k.shape)
    sc64 = np.zeros(sl_k.shape)
    with np.errstate(invalid="ignore"):
        for lo in range(0, q64.shape[0], 128):  # bound the f64 scores
            sl = slice(lo, lo + 128)
            full = sq64[sl, None, :] - 2.0 * np.einsum(
                "bqk,bck->bqc", q64[sl], b64[sl])
            terms = np.abs(sq64[sl, None, :]) + 2.0 * np.einsum(
                "bqk,bck->bqc", np.abs(q64[sl]), np.abs(b64[sl]))
            sl64[sl], tie[sl], mag[sl] = f64_search(full, terms)
            sc64[sl] = np.min(full, axis=-1)
    fin = np.isfinite(sc64) & (np.asarray(valid) > 0)
    same_inf = bool(np.all(np.isfinite(sc_k) == np.isfinite(sc64))
                    and np.all(np.isfinite(sc_t) == np.isfinite(sc64)))
    d64 = np.abs(sc_k - sc64)[fin]
    d_t = np.abs(sc_k - sc_t)[fin]
    mag = np.maximum(mag[fin], 1e-30)
    # The kernel is held to 1e-5 relative + 1e-3 mm^2 of the float64
    # scores; the twin's bf16x3 products round at ~1.1e-5 of the terms
    # (3 x 2^-18), so kernel and twin must agree within 3e-5 of them.
    score_ok = (same_inf
                and bool(np.all(d64 <= 1e-5 * np.abs(sc64[fin]) + 1e-3))
                and bool(np.all(d_t <= 3e-5 * mag)))
    bad = ((sl_k != sl_t) | (sl_k != sl64)) & fin & ~tie
    report("e", what=f"bin_nn kernel vs twin, {label}",
           slots_differ_kernel_twin=int(((sl_k != sl_t) & fin).sum()),
           slots_differ_kernel_f64=int(((sl_k != sl64) & fin).sum()),
           slots_differ_twin_f64=int(((sl_t != sl64) & fin).sum()),
           differ_outside_near_ties=int(bad.sum()),
           near_ties=int((tie & fin).sum()),
           kernel_f64_max_abs=float(d64.max()),
           kernel_f64_max_over_score=float(np.max(
               d64 / np.maximum(np.abs(sc64[fin]), 1e-30))),
           kernel_twin_max_abs=float(d_t.max()),
           kernel_twin_max_over_terms=float(np.max(d_t / mag)),
           twin_f64_max_abs=float(np.max(np.abs(sc_t - sc64)[fin])),
           scores_ok=score_ok)
    check("e", score_ok and not np.any(bad), f"bin_nn parity at {label}")


def dot3_anchor(moving, C, srow):
    """How far dot3's scores are from float64, with its reduce_precision
    anchor and with a plain bf16 round trip in its place."""
    import jax
    import jax.numpy as jnp

    from icp_tpu.ops.distance import dot3

    dims = (((1,), (0,)), ((), ()))

    def naive(a, b):
        a_hi = a.astype(jnp.bfloat16).astype(jnp.float32)
        b_hi = b.astype(jnp.bfloat16).astype(jnp.float32)
        f = lambda x, y: jax.lax.dot_general(  # noqa: E731
            x.astype(jnp.bfloat16), y.astype(jnp.bfloat16), dims,
            preferred_element_type=jnp.float32)
        return f(a_hi, b_hi) + f(a_hi, b - b_hi) + f(a - a_hi, b_hi)

    ref = np.asarray(moving, np.float64) @ np.asarray(C, np.float64)
    scale = np.max(np.abs(ref))
    out = {}
    for name, fn in (("reduce_precision", lambda a, b: dot3(a, b, dims)),
                     ("bf16_round_trip", naive)):
        got = np.asarray(jax.jit(fn)(moving, C), np.float64)
        out[name] = float(np.max(np.abs(got - ref)) / scale)
    report("e", what="dot3 max error / max |p.C| vs float64, 16x scores",
           **out)


def phase_e(reg, flag, flag_ms, big, big_ms):
    la, lb, _q, _t, flag_cfg = flag
    fixed, moving, big_cfg = big
    kernel_parity("flagship 16384 x 256", la, lb, flag_cfg)
    kernel_parity("16x 262144 x 2048", fixed, moving, big_cfg)

    import dataclasses

    from icp_tpu import ICPParams, Objective
    from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
    from icp_tpu.icp.run import build_index
    from icp_tpu.icp.state import identity_state
    from icp_tpu.rbc.fused_point import prep_rep_assign, prep_similarity

    params = ICPParams(alpha=2e2).as_f32()
    index = build_index(fixed, params, big_cfg)
    st = identity_state()
    G, b_row = prep_similarity(st.q, st.t, st.s)
    C, srow = prep_rep_assign(index.reps, params.alpha, G, b_row)
    dot3_anchor(moving, C, srow)

    # Kernels vs twins end to end. Accuracy on PLANE, which converges in a
    # few iterations to a sharp optimum (POINT creeps along its lattice
    # floor for tens of iterations, so two runs part by more than the
    # 1e-3 mm bound whichever search they use); speed on POINT.
    twin = register_with("xla")
    lidar = dataclasses.replace(big_cfg, estimate_scale=False,
                                objective=Objective.PLANE, normal_mode="knn")
    plane = dataclasses.replace(flag_cfg, estimate_scale=False,
                                objective=Objective.PLANE)
    for label, (f, m, cfg) in {"flagship PLANE": (la, lb, plane),
                               "16x LiDAR PLANE": (fixed, moving, lidar)
                               }.items():
        a = reg(f, m, params, cfg)
        b = twin(f, m, params, cfg)
        dt = float(np.linalg.norm(np.asarray(a.t) - np.asarray(b.t)))
        da = float(qangle_deg(qmul(a.q, qconj(b.q))))
        report("e", what=f"register kernels vs twins, {label}",
               t_diff_mm=dt, ang_diff_deg=da, k_kernels=int(a.k),
               k_twins=int(b.k))
        check("e", dt < 1e-3 and da < 1e-4,
              f"{label} register kernels vs twins differ by {dt} mm, "
              f"{da} deg")
    # Each kernel on its own: swap one for its twin, keep the other.
    twin_assign = register_with("xla", only=("rep_assign",))
    twin_nn = register_with("xla", only=("bin_nn",))
    for label, (f, m, cfg, k_ms) in {
            "flagship": (la, lb, flag_cfg, flag_ms),
            "16x": (fixed, moving, big_cfg, big_ms)}.items():
        report("e", what=f"POINT ms/iteration kernels vs twins, {label}",
               both_kernels=k_ms,
               rep_assign_twin_bin_nn_kernel=ms_per_iteration(
                   twin_assign, f, m, cfg),
               rep_assign_kernel_bin_nn_twin=ms_per_iteration(
                   twin_nn, f, m, cfg),
               both_twins=ms_per_iteration(twin, f, m, cfg))

    import pytest

    # The tests that only the card can run, in this process (one process
    # per card): conftest leaves the platform alone under this variable.
    os.environ["ICP_TEST_DEVICE"] = "gpu"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu_kernels.py")])
    report("e", what="gpu-marked tests", pytest_exit=int(rc))
    check("e", rc == 0, f"gpu-marked tests exit {int(rc)}")


def phase_four(m: int = 262144, n_r: int = 2048):
    """Sharded registration over four cards vs one card, 16x pair.

    LiDAR PLANE (kNN normals), which converges in a few iterations to a
    sharp optimum: POINT creeps along its lattice floor for tens of
    iterations, and the sharded path's own query capacities and summation
    order then part it from the one-card run by more than the bound.
    """
    import jax
    import jax.numpy as jnp

    from icp_tpu import ICPConfig, ICPParams, Objective, register
    from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
    from icp_tpu.parallel.mesh import make_mesh, shard_points
    from icp_tpu.parallel.sharded import make_sharded_register
    from icp_tpu.sensors.synthetic import wavy_surface_pair

    n = len(jax.devices())
    check("four", n >= 4, f"--four needs 4 GPUs, JAX sees {n}")
    wf, wm, q_gt, t_gt = wavy_surface_pair(m)
    fixed, moving = jnp.asarray(wf), jnp.asarray(wm)
    config = ICPConfig(m=m, n_r=n_r, estimate_scale=False,
                       objective=Objective.PLANE, normal_mode="knn")
    params = ICPParams(alpha=2e2).as_f32()
    one = register(fixed, moving, params, config)
    t1, a1 = pose_errors(one, q_gt, t_gt)
    t_one = median_s(lambda: register(fixed, moving, params, config))
    report("four", what="single-card LiDAR PLANE register, 16x pair",
           t_err_mm=t1,
           ang_err_deg=a1, k=int(one.k), register_ms=t_one * 1e3)
    for n_dp, n_mp in ((4, 1), (2, 2)):
        mesh = make_mesh(n_dp, n_mp)
        placed = jax.device_put(moving, shard_points(mesh))
        devs = {s.device for s in placed.addressable_shards}
        check("four", len(devs) == 4 and set(mesh.devices.flat) == devs,
              f"mesh ({n_dp}, {n_mp}) does not span 4 devices: {devs}")
        row_shards = {s.index[0] for s in placed.addressable_shards}
        run = make_sharded_register(mesh, config)
        st = run(fixed, placed, params)
        dt = float(np.linalg.norm(np.asarray(st.t) - np.asarray(one.t)))
        da = float(qangle_deg(qmul(st.q, qconj(one.q))))
        t_sh = median_s(lambda: run(fixed, placed, params))
        report("four",
               what=f"sharded LiDAR PLANE register dp={n_dp} mp={n_mp}",
               t_diff_vs_one_card_mm=dt, ang_diff_vs_one_card_deg=da,
               k=int(st.k), register_ms=t_sh * 1e3,
               devices=sorted(str(d) for d in devs),
               row_shards=len(row_shards),
               out_devices=len(st.t.sharding.device_set))
        check("four", dt < 1e-2 and da < 1e-3,
              f"dp={n_dp} mp={n_mp} differs from one card by {dt} mm, "
              f"{da} deg")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        fail(f"JAX finds no GPU (default backend {backend!r})")
    try:
        from icp_tpu.runtime.cache import enable_compile_cache
    except ImportError as e:
        fail(f"icp_tpu is not importable here ({e}); run from the "
             "repository root")
    cache = enable_compile_cache()
    print(card_line(), flush=True)
    report("setup", jax=jax.__version__, devices=len(jax.devices()),
           device_kind=jax.devices()[0].device_kind, compile_cache=cache)
    t_start = time.perf_counter()

    if args.four:
        phase_four()
    else:
        from icp_tpu import ICPConfig

        flag_cfg = ICPConfig()
        reg = register_with("auto")
        la, lb, q_gt, t_gt = rendered_pair()
        flag_ms = phase_a((la, lb, q_gt, t_gt), reg, flag_cfg)
        phase_b((la, lb, q_gt, t_gt), reg, flag_cfg)
        phase_c()
        fixed, moving, big_cfg, big_ms = phase_d(reg)
        phase_e(reg, (la, lb, q_gt, t_gt, flag_cfg), flag_ms,
                (fixed, moving, big_cfg), big_ms)

    report("done", seconds=time.perf_counter() - t_start)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
