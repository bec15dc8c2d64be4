"""Multi-host initialization and global mesh construction.

Single-host multi-chip runs need nothing from here (make_mesh over local
devices). Multi-host pods initialize the jax.distributed runtime once per
process, then build a GLOBAL mesh whose ``dp`` axis spans hosts — dp
crossings ride DCN, mp stays intra-host on ICI, so the heavy per-iteration
traffic (the mp all_gathers of the sharded search) never leaves the slice
and only the 19-float psum payload crosses hosts.

The reference has no distributed story at all (SURVEY.md §2.6); this module
is the comm-backend layer of the extension.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from icp_tpu.parallel.mesh import DP_AXIS, MP_AXIS


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialize the multi-process runtime (idempotent).

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). With none set,
    jax.distributed.initialize falls back to cluster auto-detection, which
    fails on a host that no cluster manager describes — pass the
    coordinator address, process count and id explicitly there.
    """
    # Do NOT probe jax.process_count() here — it would initialize the XLA
    # backend, after which jax.distributed.initialize refuses to run.
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    import logging

    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
        try:
            kwargs["num_processes"] = int(
                num_processes if num_processes is not None
                else os.environ["JAX_NUM_PROCESSES"])
            # NOTE: "or" would misroute process 0 (falsy) to the env var.
            kwargs["process_id"] = int(
                process_id if process_id is not None
                else os.environ["JAX_PROCESS_ID"])
        except KeyError as e:
            raise ValueError(
                f"coordinator_address given but {e.args[0]} is neither "
                "passed nor set in the environment") from None
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as e:
        if "already" in str(e).lower():
            return
        if kwargs:
            raise
        # Auto-detect path on a non-pod host: expected to fail; single-host
        # runs proceed. Loudly warn so a genuine pod misconfiguration (which
        # would silently degrade to N independent runs) is visible in logs.
        logging.getLogger("icp_tpu.distributed").warning(
            "jax.distributed auto-initialization failed (%s); continuing "
            "single-process. If this is a multi-host run, set "
            "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.",
            e)


def make_global_mesh(n_dp: Optional[int] = None, n_mp: int = 1) -> Mesh:
    """Global (dp, mp) mesh over all processes' devices.

    Defaults to dp = total_devices / n_mp. Layout: devices are ordered
    process-major, so the dp axis is outermost — host boundaries fall
    between dp rows and mp stays within a host (ICI).
    """
    devs = jax.devices()
    total = len(devs)
    if n_dp is None:
        if total % n_mp != 0:
            raise ValueError(f"{total} devices not divisible by mp={n_mp}")
        n_dp = total // n_mp
    if n_dp * n_mp > total:
        raise ValueError(f"need {n_dp * n_mp} devices, have {total}")
    grid = np.asarray(devs[: n_dp * n_mp]).reshape(n_dp, n_mp)
    return Mesh(grid, (DP_AXIS, MP_AXIS))


def local_shard(array: np.ndarray, mesh: Mesh, axis: int = 0) -> np.ndarray:
    """This process's dp-slice of a host-level array (for feeding
    per-process data into a global jit without materializing the full array
    everywhere)."""
    n_dp = mesh.shape[DP_AXIS]
    if array.shape[axis] % n_dp != 0:
        raise ValueError(
            f"axis {axis} (size {array.shape[axis]}) must divide evenly "
            f"over dp={n_dp}")
    per = array.shape[axis] // n_dp
    # dp rows owned by this process (must be contiguous — the process-major
    # device ordering of make_global_mesh guarantees it; verify anyway).
    rows = [i for i in range(n_dp)
            if mesh.devices[i, 0].process_index == jax.process_index()]
    if not rows:
        raise ValueError("process owns no dp rows of this mesh")
    if rows != list(range(rows[0], rows[-1] + 1)):
        raise ValueError(f"process dp rows are non-contiguous: {rows}")
    lo = rows[0] * per
    hi = (rows[-1] + 1) * per
    sl = [slice(None)] * array.ndim
    sl[axis] = slice(lo, hi)
    return array[tuple(sl)]
