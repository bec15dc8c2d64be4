"""Benchmark: photogeometric ICP iteration latency on the flagship workload.

Headline metric (BASELINE.md): ms per ICP iteration at |F| = |M| = 16384
landmarks, |R| = 256 representatives — the reference's ~1.1 ms/iteration on
an AMD R9 270X (reference README.md:8, docs/mainpage.dox).

Method: jit the full registration loop pinned to exactly K iterations
(convergence thresholds 0 so it never stops early — the reference's 40-cap
path) for K_hi = 40 and K_lo = 8, and report the MARGINAL per-iteration
latency (T(K_hi) - T(K_lo)) / (K_hi - K_lo). Differencing removes the
constant dispatch and index-build cost while charging everything the
reference charges per iteration: transform, RBC search, weights,
reductions, rotation solve, loop bookkeeping.

Robustness contract:
the headline measurement can NEVER be lost to an accuracy gate — every
gate runs in its own try/except and records ``{gate}_error`` instead of
aborting, and the one JSON line is printed from a finally-style tail with
whatever was measured. Deterministic compile errors are not retried.

Prints ONE JSON line; vs_baseline = reference_ms / ours_ms (>1 means faster
than the reference).
"""

from __future__ import annotations

import json
import time

import numpy as np

BASELINE_MS = 1.1
ITERS_HI = 40
ITERS_LO = 8


def main() -> None:
    import jax
    import jax.numpy as jnp

    from icp_tpu import ICPConfig, ICPParams, register
    from icp_tpu.runtime.cache import enable_compile_cache
    from __graft_entry__ import _synthetic_pair

    enable_compile_cache()

    # Flagship workload: m=16384, n_r=256, POWER+WEIGHTED+RBC.
    # Zero thresholds -> always run the full iteration budget.
    params = ICPParams(alpha=2e2, angle_threshold_deg=0.0,
                       translation_threshold=0.0).as_f32()

    fixed_np, moving_np = _synthetic_pair(16384)
    fixed = jnp.asarray(fixed_np)
    moving = jnp.asarray(moving_np)

    configs = {k: ICPConfig(max_iterations=k) for k in (ITERS_HI, ITERS_LO)}
    for k, config in configs.items():  # compile + warm both variants first
        state = jax.block_until_ready(register(fixed, moving, params, config))
        assert int(state.k) == k, (int(state.k), k)

    def run_once(k: int) -> float:
        t0 = time.perf_counter()
        out = register(fixed, moving, params, configs[k])
        # The scalar host read drains the execution; its constant cost
        # cancels in the (T_hi - T_lo) differencing.
        assert int(out.k) == k
        return time.perf_counter() - t0

    # Blocks of measurements are spread across the bench's runtime and
    # min T(hi) / min T(lo) are global across all blocks. Within a block
    # hi/lo alternate so jitter hits both equally; the minima are taken
    # SEPARATELY before differencing (min-of-differences flips negative
    # under dispatch jitter).
    best = {ITERS_HI: float("inf"), ITERS_LO: float("inf")}

    def measure_block(rounds: int = 8) -> None:
        for _ in range(rounds):
            for k in (ITERS_HI, ITERS_LO):
                best[k] = min(best[k], run_once(k))

    measure_block()

    # Accuracy gates on the SAME hardware: rendered pairs with known
    # ground truth must register to the expected bound (caught a real
    # reduced-precision matmul regression once; latency alone can't). Each
    # gate is individually fenced: a gate that cannot even compile records
    # its error and flips accuracy_ok, but the headline still prints.
    from icp_tpu import Objective
    from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
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
    acc_params = ICPParams(alpha=2e2).as_f32()

    gates: dict[str, dict] = {}

    def gate(name, config, t_bound, a_bound, fixed=la, moving=lb, truth=rel):
        try:
            st = jax.block_until_ready(
                register(fixed, moving, acc_params, config))
            t_err = float(jnp.linalg.norm(st.t - truth.t))
            a_err = float(qangle_deg(qmul(st.q, qconj(truth.q))))
            gates[name] = {"ok": bool(t_err < t_bound and a_err < a_bound),
                           "t_err": t_err, "a_err": a_err, "k": int(st.k)}
        except Exception as e:  # noqa: BLE001 - record, never abort bench
            gates[name] = {"ok": False, "t_err": float("nan"),
                           "a_err": float("nan"),
                           "error": " ".join(str(e).split())[:300]}

    gate("plane", ICPConfig(estimate_scale=False, objective=Objective.PLANE),
         1.0, 0.05)
    measure_block()
    # Symmetric point-to-plane (Rusinkiewicz's objective): constrain along
    # the averaged fixed+moving normal. Same sub-mm class as PLANE; its
    # claim to fame is a wider quadratic basin, i.e. convergence in FEWER
    # iterations at equal accuracy — both k values are emitted so the
    # capture shows it (plane_k vs plane_sym_k).
    gate("plane_sym",
         ICPConfig(estimate_scale=False, objective=Objective.PLANE,
                   plane_symmetric=True),
         1.0, 0.05)
    measure_block()
    # Robust gate: 12% gross outliers injected into the moving landmarks;
    # the TRIMMED M-estimator (REGULAR weighting, so the robust kernel is
    # the only outlier defense) must still land on the truth.
    from icp_tpu import RobustKernel, Weighting

    rng_out = np.random.default_rng(5)
    lb_dirty = np.array(lb, copy=True)
    out_idx = rng_out.choice(lb_dirty.shape[0], lb_dirty.shape[0] // 8,
                             replace=False)
    lb_dirty[out_idx, :3] += (
        rng_out.uniform(250, 500, (len(out_idx), 3))
        * rng_out.choice([-1.0, 1.0], (len(out_idx), 3))).astype(np.float32)
    # PLANE objective: the rendered-pair POINT floor is the ~3 mm sample
    # lattice (that is what the PLANE gate exists to beat), so the robust
    # gate must use PLANE to see sub-mm through the contamination.
    gate("robust",
         ICPConfig(estimate_scale=False, objective=Objective.PLANE,
                   weighting=Weighting.REGULAR,
                   robust=RobustKernel.TRIMMED, robust_adaptive=True),
         1.0, 0.05, moving=jnp.asarray(lb_dirty))
    measure_block()
    # GICP: plane-to-plane Mahalanobis, same sub-mm class as PLANE.
    gate("gicp", ICPConfig(estimate_scale=False, objective=Objective.GICP),
         1.0, 0.05)
    measure_block()

    # 4x workload (m=65536 landmarks, n_r=1024 representatives): the
    # flagship shape is launch-latency-bound, so the device's throughput
    # shows at scale. Same marginal differencing as the headline.
    best4 = {ITERS_HI: float("inf"), ITERS_LO: float("inf")}
    four_x: dict[str, float | str] = {}
    ctx4: dict = {}

    def measure_block4(rounds: int = 6) -> None:
        """Safe anywhere: no-op once the 4x path has recorded an error."""
        if four_x or not ctx4:
            return
        try:
            for _ in range(rounds):
                for k in (ITERS_HI, ITERS_LO):
                    t0 = time.perf_counter()
                    out = register(ctx4["fixed"], ctx4["moving"], params,
                                   ctx4["configs"][k])
                    assert int(out.k) == k
                    best4[k] = min(best4[k], time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - record, never abort bench
            four_x["icp_4x_error"] = " ".join(str(e).split())[:300]

    try:
        fixed4_np, moving4_np = _synthetic_pair(65536, seed=1)
        from icp_tpu import ICPConfig as _C

        ctx4 = {"fixed": jnp.asarray(fixed4_np),
                "moving": jnp.asarray(moving4_np),
                "configs": {k: _C(m=65536, n_r=1024, max_iterations=k)
                            for k in (ITERS_HI, ITERS_LO)}}
        for k in (ITERS_HI, ITERS_LO):  # compile + warm (zero thresholds)
            st4 = jax.block_until_ready(
                register(ctx4["fixed"], ctx4["moving"], params,
                         ctx4["configs"][k]))
            assert int(st4.k) == k, (int(st4.k), k)
        measure_block4()
    except Exception as e:  # noqa: BLE001 - record, never abort bench
        four_x["icp_4x_error"] = " ".join(str(e).split())[:300]

    # Scaled-shape ACCURACY gates: the 4x/16x latency
    # captures ride the same bench run as a ground-truth registration at
    # the same shape — two INDEPENDENT samplings of an analytic surface
    # (approximate correspondences, a real registration problem) under a
    # known rigid transform. The registration reuses the warmed perf
    # program (same static config; thresholds are dynamic, so it converges
    # naturally within the K=40 budget — zero extra compiles).
    from icp_tpu.sensors.synthetic import wavy_surface_pair

    def scale_gate(name, ctx, m):
        if not ctx:
            return
        try:
            wf, wm, q_gt, t_gt = wavy_surface_pair(m)
            st = jax.block_until_ready(register(
                jnp.asarray(wf), jnp.asarray(wm), acc_params,
                ctx["configs"][ITERS_HI]))
            t_err = float(jnp.linalg.norm(st.t - jnp.asarray(t_gt)))
            a_err = float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q_gt)))))
            gates[name] = {"ok": bool(t_err < 1.0 and a_err < 0.05),
                           "t_err": t_err, "a_err": a_err, "k": int(st.k)}
        except Exception as e:  # noqa: BLE001 - record, never abort bench
            gates[name] = {"ok": False, "t_err": float("nan"),
                           "a_err": float("nan"),
                           "error": " ".join(str(e).split())[:300]}

    scale_gate("icp_4x", ctx4, 65536)
    measure_block()
    measure_block4()

    # 16x workload (m=262144 landmarks, n_r=2048 representatives): the
    # first shape where the device does real per-iteration work — the
    # reference cannot run it at all (its m is hard-capped at 16384,
    # src/ICP/algorithms.cpp:666). Same marginal differencing; fewer
    # rounds.
    best16 = {ITERS_HI: float("inf"), ITERS_LO: float("inf")}
    sixteen_x: dict[str, float | str] = {}
    ctx16: dict = {}

    def measure_block16(rounds: int = 2) -> None:
        """Safe anywhere: no-op once the 16x path has recorded an error."""
        if sixteen_x or not ctx16:
            return
        try:
            for _ in range(rounds):
                for k in (ITERS_HI, ITERS_LO):
                    t0 = time.perf_counter()
                    out = register(ctx16["fixed"], ctx16["moving"], params,
                                   ctx16["configs"][k])
                    assert int(out.k) == k
                    best16[k] = min(best16[k], time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - record, never abort bench
            sixteen_x["icp_16x_error"] = " ".join(str(e).split())[:300]

    try:
        fixed16_np, moving16_np = _synthetic_pair(262144, seed=2)
        ctx16 = {"fixed": jnp.asarray(fixed16_np),
                 "moving": jnp.asarray(moving16_np),
                 "configs": {k: _C(m=262144, n_r=2048, max_iterations=k)
                             for k in (ITERS_HI, ITERS_LO)}}
        for k in (ITERS_HI, ITERS_LO):
            st16 = jax.block_until_ready(
                register(ctx16["fixed"], ctx16["moving"], params,
                         ctx16["configs"][k]))
            assert int(st16.k) == k, (int(st16.k), k)
        measure_block16()
    except Exception as e:  # noqa: BLE001 - record, never abort bench
        sixteen_x["icp_16x_error"] = " ".join(str(e).split())[:300]

    scale_gate("icp_16x", ctx16, 262144)

    # LiDAR-scale unorganized gate: PLANE registration
    # at m=262144 with normals from RBC-accelerated geometric kNN PCA
    # (normal_mode="knn" routes to ops.normals.knn_normals_rbc above 16384
    # points — the path that kills the O(m^2) brute kNN the round-4 review
    # flagged). The same ground-truth pair as the 16x gate, treated as an
    # unorganized sweep; plus the marginal on-chip latency of the normals
    # stage itself (fori_loop differencing — the estimator output feeds
    # back into its input so XLA cannot hoist the loop-invariant call).
    try:
        from functools import partial as _partial

        from icp_tpu.ops.normals import knn_normals_rbc

        wf16, wm16, q16, t16 = wavy_surface_pair(262144)
        cfg_lidar = _C(m=262144, n_r=2048, estimate_scale=False,
                       objective=Objective.PLANE, normal_mode="knn")
        stl = jax.block_until_ready(register(
            jnp.asarray(wf16), jnp.asarray(wm16), acc_params, cfg_lidar))
        l_t = float(jnp.linalg.norm(stl.t - jnp.asarray(t16)))
        l_a = float(qangle_deg(qmul(stl.q, qconj(jnp.asarray(q16)))))
        gates["lidar"] = {"ok": bool(l_t < 1.0 and l_a < 0.05),
                          "t_err": l_t, "a_err": l_a, "k": int(stl.k)}

        pts16 = jnp.asarray(wf16)

        @_partial(jax.jit, static_argnames=("n",))
        def knn_loop(p, n):
            def body(i, p):
                nrm = knn_normals_rbc(p)
                return p.at[:, :3].add(nrm * 1e-20)
            return jax.lax.fori_loop(0, n, body, p)

        def knn_time(n):
            jax.block_until_ready(knn_loop(pts16, n))  # compile
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(knn_loop(pts16, n))
                best = min(best, time.perf_counter() - t0)
            return best

        t_hi_n, t_lo_n = knn_time(10), knn_time(2)
        sixteen_x["knn_normals_ms_262144"] = round(
            (t_hi_n - t_lo_n) / 8 * 1e3, 3)
    except Exception as e:  # noqa: BLE001 - record, never abort bench
        gates["lidar"] = {"ok": False, "t_err": float("nan"),
                          "a_err": float("nan"),
                          "error": " ".join(str(e).split())[:300]}

    # Pyramid gate: coarse-to-fine from a LARGE offset (outside the
    # single-level basin for fast motion) must still land on the truth.
    q_big = np.array([0, np.sin(0.03), 0, np.cos(0.03)], np.float32)
    t_big = np.array([60.0, -40.0, 30.0], np.float32)
    pose_c = synthetic.CameraPose(jnp.asarray(q_big), jnp.asarray(t_big))
    lc = get_landmarks(synthetic.render_cloud(scene, pose_c).reshape(-1, 8))
    rel_c = se3.relative(synthetic.CameraPose.identity(), pose_c)
    try:
        from icp_tpu.icp.pyramid import register_pyramid

        stp = jax.block_until_ready(register_pyramid(
            la, lc, acc_params,
            ICPConfig(estimate_scale=False, objective=Objective.PLANE),
            strides=(4, 2, 1)))
        pyr_t = float(jnp.linalg.norm(stp.t - rel_c.t))
        pyr_a = float(qangle_deg(qmul(stp.q, qconj(rel_c.q))))
        gates["pyramid"] = {"ok": bool(pyr_t < 2.0 and pyr_a < 0.1),
                            "t_err": pyr_t, "a_err": pyr_a}
    except Exception as e:  # noqa: BLE001 - record, never abort bench
        gates["pyramid"] = {"ok": False, "t_err": float("nan"),
                            "a_err": float("nan"),
                            "error": " ".join(str(e).split())[:300]}

    measure_block()
    measure_block4()
    measure_block16()
    # Wall gate: the reference's photometric-DECISIVE validation regime
    # (kg_pc8d_wall, reference data/README.md — "shrinking alpha degrades
    # it") on a real photograph texture: frontal wall, in-plane motion
    # ~2.5x the landmark pitch. Geometry is degenerate, so this is the
    # one driver-visible gate where the COLOR lanes carry the solution:
    # alpha at matching scale must recover the lateral motion to a few
    # mm, AND geometry-only alpha must miss it (proving the photometric
    # term, not a lucky geometric basin, did the work). Wall-normal z is
    # exact either way. Mirrors tests/test_wall.py's contract on the CPU;
    # here it runs on the chip, where a bf16 regression in the color
    # lanes would surface.
    try:
        from icp_tpu.sensors import realdata

        wpts, wrgb = realdata.wall_surface()
        id_q = np.array([0, 0, 0, 1], np.float32)
        wt = np.array([30.0, -15.0, 4.0], np.float32)
        wla = get_landmarks(jnp.asarray(
            realdata.observe(wpts, wrgb, id_q, np.zeros(3, np.float32))
            .reshape(-1, 8)))
        wlb = get_landmarks(jnp.asarray(
            realdata.observe(wpts, wrgb, id_q, wt).reshape(-1, 8)))
        wall_config = ICPConfig(estimate_scale=False, max_iterations=60)

        def wall_run(alpha):
            st = jax.block_until_ready(register(
                wla, wlb, ICPParams(alpha=alpha).as_f32(), wall_config))
            lat = float(np.linalg.norm(np.asarray(st.t[:2]) - wt[:2]))
            z_err = abs(float(st.t[2]) - float(wt[2]))
            return lat, z_err

        wall_lat, wall_z = wall_run(4e5)
        geo_lat, geo_z = wall_run(1e-6)
        gates["wall"] = {"ok": bool(wall_lat < 6.0 and wall_z < 0.5
                                    and geo_z < 0.5 and geo_lat > 25.0),
                         "t_err": wall_lat, "a_err": wall_z,
                         "geo_lat": geo_lat}
    except Exception as e:  # noqa: BLE001 - record, never abort bench
        gates["wall"] = {"ok": False, "t_err": float("nan"),
                         "a_err": float("nan"),
                         "error": " ".join(str(e).split())[:300]}

    # Sequence gate: a
    # 100-frame RGB-D sequence registered frame-to-frame as ONE device
    # dispatch (lax.scan of full registrations), with drift measured
    # against the ground-truth trajectory. Makes the odometry/SLAM claims
    # as driver-reproducible as the iteration latency: ATE is global
    # consistency over the whole path, RPE(10) is local drift per 10
    # frames (Sturm et al. TUM metrics), and frames/s is the marginal
    # rate ((T(100) - T(50)) / 50 — same differencing as the headline).
    # The frames are REAL-DATA observations (sensors/realdata.py): USGS
    # airborne-LiDAR terrain geometry textured with a real photograph,
    # reprojected per pose with an occlusion-aware z-buffer — real surface
    # statistics, resampling artifacts, and invalid-pixel holes in the
    # numbers. Captured Kinect sequences are not vendored; this is the
    # strictest available substitute. Bounds are wider than the synthetic
    # scene's: real terrain adds occlusion holes and resampling noise per
    # frame.
    seq: dict[str, float | str] = {}
    try:
        from functools import partial

        from icp_tpu.sensors import realdata
        from icp_tpu.slam.odometry import (absolute_trajectory_error,
                                           odometry_chain_device,
                                           relative_pose_error)
        from icp_tpu.slam.se3 import Pose

        n_frames = 100
        poses = synthetic.orbit_trajectory(n_frames, radius_mm=120.0,
                                           yaw_rad=0.12)
        surface = realdata.terrain_surface()
        lms = jnp.stack([
            get_landmarks(jnp.asarray(frame.reshape(-1, 8)))
            for frame in realdata.terrain_frames(
                ((np.asarray(p.q), np.asarray(p.t)) for p in poses),
                surface=surface)])
        jax.block_until_ready(lms)
        measure_block()
        measure_block4()
        measure_block16()

        # GICP per frame: on this exact sequence the anisotropic
        # plane-to-plane metric drifts about half as much as PLANE on the
        # rough real terrain (ATE/RPE10 of PLANE 32.3/8.7, plane_sym
        # 26.6/7.6, GICP 17.1/4.5 mm, measured before the GPU port).
        # GICP converges by ~6 iterations on frame-to-frame motion, so
        # mi=8 keeps a margin.
        seq_config = ICPConfig(max_iterations=8, estimate_scale=False,
                               objective=Objective.GICP)
        # Zero-threshold params (the headline's): every frame runs the
        # full iteration budget, so the ks[-1] host read is a stable drain
        # and frames/s is comparable across captures.
        chain = jax.jit(partial(odometry_chain_device, params=params,
                                config=seq_config))

        def run_chain(seq_lms):
            t0 = time.perf_counter()
            wq, wt, ks = chain(seq_lms)
            assert int(ks[-1]) == 8  # host read drains the async chain
            return time.perf_counter() - t0, wq, wt

        run_chain(lms)             # compile full length
        run_chain(lms[: n_frames // 2])  # compile half length
        t_hi = t_lo = float("inf")
        for _ in range(3):
            t_hi = min(t_hi, run_chain(lms)[0])
            t_lo = min(t_lo, run_chain(lms[: n_frames // 2])[0])
        _, wq, wt = run_chain(lms)
        fps = (n_frames - n_frames // 2) / max(t_hi - t_lo, 1e-9)

        est = [Pose(np.asarray(wq[i]), np.asarray(wt[i]))
               for i in range(n_frames)]
        gt = [se3.relative(poses[0], p) for p in poses]
        ate = absolute_trajectory_error(est, gt)
        rpe_t, _rpe_r = relative_pose_error(est, gt, delta=10)
        path = sum(float(np.linalg.norm(np.asarray(gt[i + 1].t)
                                        - np.asarray(gt[i].t)))
                   for i in range(n_frames - 1))
        # Real-terrain bounds: GICP measured 17.1/4.5 mm on this
        # sequence before the GPU port; 22/5.5 keeps that margin.
        gates["sequence"] = {"ok": bool(ate < 22.0 and rpe_t < 5.5),
                             "t_err": ate, "a_err": _rpe_r}
        seq = {"odometry_ate_mm_100f": round(ate, 3),
               "odometry_rpe10_mm": round(rpe_t, 3),
               "odometry_path_mm": round(path, 1),
               "odometry_frames_per_s": round(fps, 1)}

        # Second trajectory: a rotation-heavy arc
        # (0.5 rad of yaw over the path vs the first trajectory's 0.12 —
        # per-frame rotation dominates translation), so the sequence gate
        # and its mi=8 iteration budget are exercised on a motion profile
        # they were NOT tuned on. Same surface, same compiled chain
        # (identical shapes/config — zero extra compiles beyond render).
        poses_b = synthetic.orbit_trajectory(n_frames, radius_mm=60.0,
                                             yaw_rad=0.5)
        lms_b = jnp.stack([
            get_landmarks(jnp.asarray(frame.reshape(-1, 8)))
            for frame in realdata.terrain_frames(
                ((np.asarray(p.q), np.asarray(p.t)) for p in poses_b),
                surface=surface)])
        _, wq_b, wt_b = run_chain(lms_b)
        est_b = [Pose(np.asarray(wq_b[i]), np.asarray(wt_b[i]))
                 for i in range(n_frames)]
        gt_b = [se3.relative(poses_b[0], p) for p in poses_b]
        ate_b = absolute_trajectory_error(est_b, gt_b)
        rpe_b, _ = relative_pose_error(est_b, gt_b, delta=10)
        # Rotation-heavy bounds: measured 23.1 / 5.8 (CPU calibration,
        # 2026-08-20) — the profile is genuinely harder than the first
        # trajectory (4x the yaw over half the radius), so its gate is
        # calibrated separately at ~1.3x margin, not copied from the
        # translation-dominant bounds.
        gates["sequence_rot"] = {"ok": bool(ate_b < 30.0 and rpe_b < 7.5),
                                 "t_err": ate_b, "a_err": rpe_b}
        seq["odometry_rot_ate_mm_100f"] = round(ate_b, 3)
        seq["odometry_rot_rpe10_mm"] = round(rpe_b, 3)
    except Exception as e:  # noqa: BLE001 - record, never abort bench
        gates["sequence"] = {"ok": False, "t_err": float("nan"),
                             "a_err": float("nan"),
                             "error": " ".join(str(e).split())[:300]}

    measure_block()
    measure_block4()
    # SLAM capstone gate: a closed-loop trajectory over
    # the SAME real-terrain surface driven through SlamEngine ON THE CHIP —
    # per-frame odometry, grid-gated loop-closure detection, batched
    # verification, and the pose-graph backend. Emits closure
    # precision/recall vs the known poses and keyframe ATE before/after
    # optimize_map (the backend must close the accumulated drift).
    # 200 keyframes at the full m=16384 landmark grid (a coarser sub-grid
    # carries a ~2.7 mm systematic per-edge registration bias on this
    # terrain that poisons the graph optimum; m=16384 measures 0.26 mm).
    # verify_pad_to=16 keeps the whole session at ONE vmapped-verify
    # compile instead of log2-many.
    slam: dict[str, float | str] = {}
    try:
        from icp_tpu.slam.mapping import LoopClosureConfig, SlamEngine
        from icp_tpu.slam.odometry import KeyframePolicy

        n_slam = 200
        slam_poses = []
        for i in range(n_slam):
            a = 2 * np.pi * i / n_slam
            slam_poses.append((np.array([0, 0, 0, 1], np.float32),
                               np.array([120.0 * np.cos(a) - 120.0,
                                         120.0 * np.sin(a), 0.0],
                                        np.float32)))

        # Host-side landmark sampling: bit-identical to ops.sampling.
        # get_landmarks (landmark[r,l] = cloud[49+3r, 65+4l]; parity
        # asserted in tests/test_ops.py) but a numpy strided slice, so the
        # 9.8 MB full frames never go to the device — only the 200
        # (16384, 8) keyframe clouds do.
        slam_frames = [
            jnp.asarray(np.ascontiguousarray(
                f[49:49 + 384:3, 65:65 + 512:4].reshape(16384, 8)))
            for f in realdata.terrain_frames(iter(slam_poses),
                                             surface=surface)]
        eng = SlamEngine(
            params=ICPParams(alpha=2e2),
            config=ICPConfig(estimate_scale=False,
                             objective=Objective.GICP, max_iterations=8),
            policy=KeyframePolicy(max_gap=1),
            loop_config=LoopClosureConfig(max_distance=60.0,
                                          max_angle_deg=20.0, min_gap=50,
                                          verify_pad_to=16),
        )
        t0 = time.perf_counter()
        for fr in slam_frames:
            eng.process_frame(fr)
        t_frames = time.perf_counter() - t0

        ts_gt = np.stack([t for _, t in slam_poses])
        closure_set = set(eng.map.loop_closures)
        correct = 0
        for (ci, cj), meas in zip(eng.map.edges, eng.map.measurements):
            if (ci, cj) not in closure_set:
                continue
            gi = eng.map.keyframes[ci].index
            gj = eng.map.keyframes[cj].index
            gt_rel = se3.relative(
                se3.Pose(jnp.asarray(slam_poses[gi][0]),
                         jnp.asarray(slam_poses[gi][1])),
                se3.Pose(jnp.asarray(slam_poses[gj][0]),
                         jnp.asarray(slam_poses[gj][1])))
            if (float(jnp.linalg.norm(meas.t - gt_rel.t)) < 6.0
                    and float(qangle_deg(qmul(meas.q,
                                              qconj(gt_rel.q)))) < 1.5):
                correct += 1
        precision = correct / max(len(eng.map.loop_closures), 1)
        true_pairs = {(i, j) for j in range(n_slam)
                      for i in range(j - eng.loop_config.min_gap)
                      if np.linalg.norm(ts_gt[j] - ts_gt[i]) < 20.0}
        kf_pairs = {(eng.map.keyframes[i].index,
                     eng.map.keyframes[j].index)
                    for (i, j) in eng.map.loop_closures}
        recall = (sum(1 for p_ in true_pairs if p_ in kf_pairs)
                  / max(len(true_pairs), 1))

        def kf_ate():
            errs = [np.linalg.norm(np.asarray(kf.pose.t)
                                   - (ts_gt[kf.index] - ts_gt[0]))
                    for kf in eng.map.keyframes]
            return float(np.sqrt(np.mean(np.square(errs))))

        ate_before = kf_ate()
        eng.optimize_map(iterations=10)
        ate_after = kf_ate()
        # Calibrated before the GPU port: precision 1.0, recall 1.0, ATE
        # 47.3 -> 30.3 mm. The residual is the bowed loop
        # interior a single head-tail closure cannot fix (the odometry
        # carries a measured ~0.26 mm/edge systematic bias on this
        # terrain); the gate demands the backend close >= 20% of the
        # drift, with precision/recall at SLAM-production levels.
        gates["slam"] = {"ok": bool(precision >= 0.9 and recall >= 0.8
                                    and ate_after < 40.0
                                    and ate_after < 0.8 * ate_before),
                         "t_err": ate_after, "a_err": ate_before}
        slam = {"slam_keyframes": len(eng.map.keyframes),
                "slam_closures": len(eng.map.loop_closures),
                "slam_closure_precision": round(precision, 4),
                "slam_closure_recall": round(recall, 4),
                "slam_ate_before_mm": round(ate_before, 3),
                "slam_ate_after_mm": round(ate_after, 3),
                "slam_frames_per_s": round(n_slam / max(t_frames, 1e-9), 1)}
    except Exception as e:  # noqa: BLE001 - record, never abort bench
        gates["slam"] = {"ok": False, "t_err": float("nan"),
                         "a_err": float("nan"),
                         "error": " ".join(str(e).split())[:300]}

    # Two more spread-out blocks; ~10 s apart, widening the sampled drift
    # horizon to the whole bench runtime (4x/16x blocks interleaved the
    # same).
    measure_block()
    measure_block4()
    measure_block16()
    time.sleep(10)
    measure_block()
    measure_block4()
    measure_block16()
    per_iter_ms = (best[ITERS_HI] - best[ITERS_LO]) / (ITERS_HI - ITERS_LO) * 1e3
    if not four_x and all(np.isfinite(v) for v in best4.values()):
        per_iter_4x = ((best4[ITERS_HI] - best4[ITERS_LO])
                       / (ITERS_HI - ITERS_LO) * 1e3)
        four_x["icp_iteration_ms_f65536_r1024"] = round(per_iter_4x, 4)
    if ("icp_16x_error" not in sixteen_x
            and all(np.isfinite(v) for v in best16.values())):
        per_iter_16x = ((best16[ITERS_HI] - best16[ITERS_LO])
                        / (ITERS_HI - ITERS_LO) * 1e3)
        sixteen_x["icp_iteration_ms_f262144_r2048"] = round(per_iter_16x, 4)

    out = {
        "metric": "icp_iteration_ms_f16384_r256",
        "value": round(per_iter_ms, 4),
        "unit": "ms/iteration",
        "vs_baseline": round(BASELINE_MS / per_iter_ms, 3),
        "accuracy_ok": bool(all(g["ok"] for g in gates.values())),
    }
    for name, g in gates.items():
        if name in ("sequence", "sequence_rot", "slam"):
            continue  # reported via the odometry_* / slam_* keys below
        if name == "wall":  # lateral/z split, not a transform error pair
            out["wall_lat_err_mm"] = round(g["t_err"], 4)
            out["wall_z_err_mm"] = round(g["a_err"], 4)
            if "geo_lat" in g:
                out["wall_geo_lat_err_mm"] = round(g["geo_lat"], 4)
            if "error" in g:
                out["wall_error"] = g["error"]
            continue
        out[f"{name}_t_err_mm"] = round(g["t_err"], 4)
        out[f"{name}_ang_err_deg"] = round(g["a_err"], 5)
        if "error" in g:
            out[f"{name}_error"] = g["error"]
    # Convergence-speed evidence for the symmetric objective: iterations
    # to the thresholds at equal accuracy (expected plane_sym_k < plane_k).
    for name in ("plane", "plane_sym"):
        if "k" in gates.get(name, {}):
            out[f"{name}_k"] = gates[name]["k"]
    out.update(four_x)
    out.update(sixteen_x)
    out.update(seq)
    out.update(slam)
    for name in ("sequence", "sequence_rot", "slam"):
        if "error" in gates.get(name, {}):
            out[f"{name}_error"] = gates[name]["error"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
