#!/usr/bin/env python
"""Synthetic frame grabber — the reference's ``kinect_frame_grabber``
(src/kinect_frame_grabber.cpp) with the analytic renderer standing in for
libfreenect: renders RGB-D, optionally guided-filters it (the reference's
``-f`` flag), back-projects with the f=595 pinhole model, and writes
reference-format ``<dir>/kg_pc8d_<suffix>.bin`` clouds.

Usage:
    python examples/frame_grabber.py [-f] [-s SUFFIX] [--out-dir DIR]
        [--pose X Y Z YAW]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--filter", action="store_true",
                    help="guided-filter the RGB-D frames (reference -f)")
    ap.add_argument("-s", "--suffix", default="1",
                    help="output name suffix (reference -s)")
    ap.add_argument("--out-dir", default="data")
    ap.add_argument("--pose", nargs=4, type=float, default=[0, 0, 0, 0],
                    metavar=("X", "Y", "Z", "YAW"),
                    help="camera pose: translation mm + yaw rad")
    args = ap.parse_args()
    from icp_tpu.runtime.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from icp_tpu.runtime.native import write_cloud, validate_cloud
    from icp_tpu.sensors import guided_filter as gf
    from icp_tpu.sensors import pinhole, synthetic

    x, y, z, yaw = args.pose
    q = np.array([0, np.sin(yaw / 2), 0, np.cos(yaw / 2)], np.float32)
    pose = synthetic.CameraPose(jnp.asarray(q),
                                jnp.asarray(np.array([x, y, z], np.float32)))
    scene = synthetic.default_scene()
    depth, rgb = synthetic.render(scene, pose)

    if args.filter:
        print("Applying guided filter (radius=5, eps=0.005)")
        rgb = gf.filter_rgb(rgb)
        depth = gf.filter_depth(depth)

    cloud = np.asarray(pinhole.backproject(depth, rgb)).reshape(-1, 8)
    n_valid = validate_cloud(cloud)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"kg_pc8d_{args.suffix}.bin")
    write_cloud(path, cloud)
    print(f"Point cloud saved in {path} ({n_valid} valid points)")


if __name__ == "__main__":
    main()
