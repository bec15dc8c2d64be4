"""Worker for the true multi-process distributed tests.

Launched (2x) by tests/test_multiprocess.py: initializes jax.distributed on
the CPU backend (Gloo collectives — the DCN stand-in), builds a global
(dp, mp) mesh spanning both processes, forms global sharded arrays from
process-local data, runs the sharded registration, and prints the resulting
transform for the parent to compare.

argv: port pid variant n_local_devices n_dp n_mp [with_pg]
  variant: point | plane | gicp (objective/weighting preset).
  with_pg: "1" additionally runs the edge-sharded pose-graph LM-PCG on the
    deterministic ring fixture (slam.pose_graph.demo_ring_graph) over the
    SAME global mesh and prints a RESULT_PG line — the driver dry run's
    multi-process section consumes it.
"""

import os
import sys


def _config(variant: str, m: int):
    from icp_tpu import (Correspondence, ICPConfig, Objective, RotationMode,
                        Weighting)

    base = dict(m=m, n_r=64, correspondence=Correspondence.RBC,
                estimate_scale=False, max_iterations=20)
    if variant == "point":
        return ICPConfig(rotation=RotationMode.POWER,
                         weighting=Weighting.WEIGHTED, **base)
    if variant == "plane":
        return ICPConfig(objective=Objective.PLANE, **base)
    if variant == "gicp":
        return ICPConfig(objective=Objective.GICP, **base)
    raise ValueError(variant)


def main():
    port = sys.argv[1]
    pid = int(sys.argv[2])
    variant = sys.argv[3] if len(sys.argv) > 3 else "point"
    n_local = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    n_dp = int(sys.argv[5]) if len(sys.argv) > 5 else 2
    n_mp = int(sys.argv[6]) if len(sys.argv) > 6 else 1

    os.environ["JAX_PLATFORMS"] = "cpu"
    if n_local > 1:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n_local}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from icp_tpu.parallel.distributed import initialize_multihost

    initialize_multihost(coordinator_address=f"localhost:{port}",
                         num_processes=2, process_id=pid)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from icp_tpu import ICPParams
    from icp_tpu.parallel.distributed import make_global_mesh
    from icp_tpu.parallel.sharded import make_sharded_register

    mesh = make_global_mesh(n_dp=n_dp, n_mp=n_mp)
    assert len(jax.devices()) == 2 * n_local, jax.devices()

    # Deterministic pair, identical in both processes.
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import _synthetic_pair

    m = 4096
    fixed_np, moving_np = _synthetic_pair(m, seed=7)

    config = _config(variant, m)
    params = ICPParams(alpha=2e2, angle_threshold_deg=0.0,
                       translation_threshold=0.0).as_f32()

    # fixed: replicated; moving: dp-sharded (each process owns its rows).
    fixed = jax.make_array_from_callback(
        fixed_np.shape, NamedSharding(mesh, P()),
        lambda idx: fixed_np[idx])
    moving = jax.make_array_from_callback(
        moving_np.shape, NamedSharding(mesh, P("dp", None)),
        lambda idx: moving_np[idx])

    run = make_sharded_register(mesh, config)
    state = jax.block_until_ready(run(fixed, moving, params))

    T = np.asarray(jax.device_get(state.T))
    k = int(state.k)
    print(f"RESULT {pid} k={k} T=" + ",".join(f"{v:.6f}" for v in T),
          flush=True)

    if len(sys.argv) > 7 and sys.argv[7] == "1":
        # Pose-graph phase: edges sharded over the dp axis ACROSS the
        # process boundary; every process holds the identical replicated
        # graph and prints the identical optimized result.
        from icp_tpu.slam.pose_graph import (demo_ring_graph, graph_cost,
                                             make_sharded_optimize_pcg,
                                             pad_edges)

        graph = demo_ring_graph()
        n_nodes = int(graph.q.shape[0])
        run_pg = make_sharded_optimize_pcg(mesh, n_nodes=n_nodes,
                                           iterations=6, cg_iterations=48)
        out = jax.block_until_ready(run_pg(pad_edges(graph, n_dp * n_mp)))
        cost = float(graph_cost(graph._replace(q=out.q, t=out.t)))
        t_last = np.asarray(jax.device_get(out.t))[n_nodes - 1]
        print(f"RESULT_PG {pid} cost={cost:.6e} t_last="
              + ",".join(f"{v:.4f}" for v in t_last), flush=True)


if __name__ == "__main__":
    main()
