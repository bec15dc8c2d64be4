#!/usr/bin/env python
"""Full registration — the reference's ``icp_registration`` app
(examples/registration.cpp): load (or synthesize) a cloud pair, run ICP to
convergence in one device dispatch, report, and export before/after views.

Usage:
    python examples/registration.py [name] [--data-dir DIR] [--synthetic]
        [--out-dir DIR] [--plot] [--robust {none,huber,tukey,trimmed}]
        [--robust-delta MM]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="kg_pc8d")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out-dir", default="/tmp/icp_tpu_reg")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--robust", default="none",
                    choices=["none", "huber", "tukey", "trimmed"],
                    help="robust M-estimator gating outlier pairs")
    ap.add_argument("--robust-delta", type=float, default=100.0,
                    help="robust kernel scale, blended-distance units (mm)")
    args = ap.parse_args()
    from icp_tpu.runtime.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from icp_tpu import ICPConfig, ICPParams, RobustKernel
    from icp_tpu.icp.pipeline import ICPRegistration
    from icp_tpu.icp.quaternion import transform_points
    from icp_tpu.sensors.io import write_ply
    from examples.step_by_step import load_pair

    fixed, moving = load_pair(args)
    app = ICPRegistration(
        ICPParams(alpha=2e2, robust_delta=args.robust_delta),
        ICPConfig(estimate_scale=False,
                  robust=RobustKernel(args.robust)))
    state = app.register_clouds(fixed, moving)

    os.makedirs(args.out_dir, exist_ok=True)
    registered = transform_points(jnp.asarray(moving).reshape(-1, 8),
                                  state.q, state.t, state.s)
    write_ply(os.path.join(args.out_dir, "fixed.ply"), np.asarray(fixed))
    write_ply(os.path.join(args.out_dir, "registered.ply"),
              np.asarray(registered))
    print(f"PLY written to {args.out_dir}")

    if args.plot:
        from icp_tpu.viz import plot_registration

        plot_registration(np.asarray(fixed), np.asarray(moving),
                          np.asarray(registered),
                          os.path.join(args.out_dir, "registration.png"))
        print(f"Plot written to {args.out_dir}/registration.png")


if __name__ == "__main__":
    main()
