#!/usr/bin/env python
"""Step-by-step photogeometric ICP — the reference's ``icp_step_by_step``
app (examples/step_by_step.cpp) without the GLUT window: each <Enter> runs
one iteration and prints the reference-format report; results are dumped as
PLY/PNG instead of a GL view.

Usage:
    python examples/step_by_step.py [name] [--data-dir DIR] [--synthetic]
        [--out-dir DIR] [--batch N]

``name`` selects ``<dir>/<name>_1.bin`` / ``<name>_2.bin`` pairs (the
reference's positional cloud-name argument, default ``kg_pc8d``); with
--synthetic (or when files are missing) a rendered Kinect-like pair with
known ground truth is used instead.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def load_pair(args):
    import jax.numpy as jnp

    p1 = os.path.join(args.data_dir, f"{args.name}_1.bin")
    p2 = os.path.join(args.data_dir, f"{args.name}_2.bin")
    if not args.synthetic and os.path.exists(p1) and os.path.exists(p2):
        from icp_tpu.runtime.native import read_cloud

        print(f"Loading {p1} / {p2}")
        return jnp.asarray(read_cloud(p1)), jnp.asarray(read_cloud(p2))

    print("Rendering synthetic Kinect pair (known ground truth)")
    from icp_tpu.sensors import synthetic

    scene = synthetic.default_scene()
    pose_a = synthetic.CameraPose.identity()
    q = np.array([0, np.sin(0.004), 0, np.cos(0.004)], np.float32)
    t = np.array([10.0, -6.0, 8.0], np.float32)
    pose_b = synthetic.CameraPose(jnp.asarray(q), jnp.asarray(t))
    fixed = synthetic.render_cloud(scene, pose_a).reshape(-1, 8)
    moving = synthetic.render_cloud(scene, pose_b).reshape(-1, 8)
    return fixed, moving


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="kg_pc8d")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out-dir", default="/tmp/icp_tpu_sbs")
    ap.add_argument("--batch", type=int, default=0,
                    help="run N steps non-interactively")
    ap.add_argument("--live", action="store_true",
                    help="stream the registration view (GUI window with "
                         "the reference's T/R/Q keys when a display "
                         "exists, PNG frames under --out-dir otherwise)")
    args = ap.parse_args()
    from icp_tpu.runtime.cache import enable_compile_cache

    enable_compile_cache()

    from icp_tpu import ICPConfig, ICPParams
    from icp_tpu.icp.pipeline import ICPStepByStep

    fixed, moving = load_pair(args)
    app = ICPStepByStep(fixed, moving, ICPParams(alpha=2e2),
                        ICPConfig(estimate_scale=False))
    app.build_rbc()

    os.makedirs(args.out_dir, exist_ok=True)

    def dump(tag):
        from icp_tpu.sensors.io import write_ply

        write_ply(os.path.join(args.out_dir, f"registered_{tag}.ply"),
                  np.asarray(app.transformed_cloud()))

    viewer = None
    if args.live:
        from icp_tpu.viz import LiveViewer

        viewer = LiveViewer(out_dir=args.out_dir)
        viewer.attach(app)
        if viewer.interactive and not args.batch:
            print("live view: T/<Enter> step | R reset | Q quit "
                  "(reference key map)")
            viewer.loop()
            dump("final")
            return

    def one_step():
        viewer.step() if viewer is not None else app.step()

    if args.batch:
        for _ in range(args.batch):
            one_step()
        dump(f"k{int(app.state.k)}")
        print(f"PLY written to {args.out_dir}"
              + (f"; {viewer.frame} live frames" if viewer else ""))
        return

    print("T=<Enter> step | R reset | Q quit   (reference key map)")
    while True:
        try:
            cmd = input("> ").strip().lower()
        except EOFError:
            break
        if cmd in ("", "t"):
            one_step()
        elif cmd == "r":
            (viewer.reset() if viewer is not None else app.reset())
            print("reset")
        elif cmd == "q":
            break
    dump("final")


if __name__ == "__main__":
    main()
