#!/usr/bin/env python
"""RGB-D odometry + SLAM demo: render a synthetic Kinect trajectory, run the
SlamEngine (frame-to-frame ICP, keyframes, loop closure, pose-graph
refinement), and report ATE against ground truth.

Usage:
    python examples/odometry.py [--frames N] [--plane] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--plane", action="store_true",
                    help="use the point-to-plane objective (sub-mm mode)")
    ap.add_argument("--out-dir", default="/tmp/icp_tpu_odometry")
    args = ap.parse_args()
    from icp_tpu.runtime.cache import enable_compile_cache

    enable_compile_cache()

    import jax

    from icp_tpu import ICPConfig, ICPParams, Objective
    from icp_tpu.sensors import synthetic
    from icp_tpu.slam import se3
    from icp_tpu.slam.mapping import SlamEngine
    from icp_tpu.slam.odometry import KeyframePolicy, absolute_trajectory_error
    from icp_tpu.runtime.metrics import MetricsSink
    from icp_tpu.runtime.timing import CPUTimer

    scene = synthetic.default_scene()
    poses_gt = synthetic.orbit_trajectory(args.frames, radius_mm=60.0,
                                          yaw_rad=0.05)
    print(f"rendering {args.frames} frames...")
    frames = [jax.block_until_ready(synthetic.render_cloud(scene, p))
              for p in poses_gt]

    config = ICPConfig(
        estimate_scale=False,
        objective=Objective.PLANE if args.plane else Objective.POINT,
    )
    eng = SlamEngine(ICPParams(alpha=2e2), config,
                     policy=KeyframePolicy(max_gap=3))
    sink = MetricsSink("odometry-demo")

    for i, cloud in enumerate(frames):
        with CPUTimer() as t:
            pose = eng.process_frame(cloud)
        sink.log("frame_ms", t.span_ms, frame=i)
        print(f"frame {i:3d}: {t.span_ms:7.1f} ms  t = {np.asarray(pose.t)}")

    gt = [se3.Pose(p.q, p.t) for p in poses_gt]
    ate_before = absolute_trajectory_error(eng.trajectory, gt)
    print(f"\nATE (odometry only)     : {ate_before:.2f} mm")
    print(f"keyframes               : {len(eng.map.keyframes)}")
    print(f"loop closures           : {len(eng.map.loop_closures)}")

    if len(eng.map.keyframes) >= 2:
        eng.optimize_map()
        kf_poses = [k.pose for k in eng.map.keyframes]
        kf_gt = [gt[k.index] for k in eng.map.keyframes]
        ate_kf = absolute_trajectory_error(kf_poses, kf_gt)
        print(f"keyframe ATE (optimized): {ate_kf:.2f} mm")

    os.makedirs(args.out_dir, exist_ok=True)
    try:
        from icp_tpu.viz import plot_trajectory

        plot_trajectory([p.t for p in eng.trajectory],
                        [p.t for p in gt],
                        os.path.join(args.out_dir, "trajectory.png"))
        print(f"trajectory plot: {args.out_dir}/trajectory.png")
    except Exception as e:  # matplotlib optional
        print(f"(no plot: {e})")
    sink.dump_jsonl(os.path.join(args.out_dir, "metrics.jsonl"))


if __name__ == "__main__":
    main()
