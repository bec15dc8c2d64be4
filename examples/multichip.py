#!/usr/bin/env python
"""Multi-chip / multi-host registration demo.

Single-host: builds a (dp, mp) mesh over the local GPUs (joined all to
all by NVLink on an H100 host) and runs the sharded registration.
Multi-host: launch one copy per host with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID set — dp spans hosts, mp is best kept
within one host.

To try the collective program without hardware:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py --dp 4 --mp 2 --cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=0, help="0 = all devices / mp")
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--m", type=int, default=16384)
    ap.add_argument("--n-r", type=int, default=256)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from icp_tpu.runtime.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from icp_tpu import ICPConfig, ICPParams
    from icp_tpu.parallel.distributed import initialize_multihost, make_global_mesh
    from icp_tpu.parallel.sharded import make_sharded_register
    from icp_tpu.runtime.timing import CPUTimer
    from __graft_entry__ import _synthetic_pair

    initialize_multihost()
    mesh = make_global_mesh(args.dp or None, args.mp)
    n_dp = mesh.shape["dp"]
    if jax.process_index() == 0:
        print(f"mesh: dp={n_dp} mp={args.mp} over {len(jax.devices())} devices, "
              f"{jax.process_count()} process(es)")

    config = ICPConfig(m=args.m, n_r=args.n_r, estimate_scale=False)
    params = ICPParams(alpha=2e2).as_f32()
    fixed_np, moving_np = _synthetic_pair(args.m)

    run = make_sharded_register(mesh, config)
    with CPUTimer() as t:
        state = jax.block_until_ready(
            run(jnp.asarray(fixed_np), jnp.asarray(moving_np), params))
    if jax.process_index() == 0:
        print(f"registered in k={int(state.k)} iterations, {t.span_ms:.1f} ms "
              f"(incl. compile on first run)")
        print("T =", np.asarray(state.T))


if __name__ == "__main__":
    main()
