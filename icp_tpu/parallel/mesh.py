"""Device-mesh setup and collective helpers.

The reference has NO distributed layer at all (single OpenCL device; its only
"transport" is staging-buffer copies — SURVEY.md §2.6/§5). This module is the
framework's comm backend: a named 2-D mesh and the collective wrappers the
sharded ICP/SLAM paths use. Axes:

  * ``dp`` — data parallel over points (queries / residuals / keyframes).
    The dominant axis: search and reduction work scale linearly in it.
  * ``mp`` — model parallel over the search structure (representatives and
    their bins). Spreads the RBC bins and the per-rep batched matmuls.

On one host the cards are joined all to all by NVLink, so the mesh's
shape follows the algorithm, not the wiring; XLA lowers the ``psum`` /
``pmin`` calls inside ``shard_map`` to NCCL collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DP_AXIS = "dp"
MP_AXIS = "mp"


def make_mesh(n_dp: int, n_mp: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Create a (dp, mp) mesh over the given (or all) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    need = n_dp * n_mp
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    grid = np.asarray(devs[:need]).reshape(n_dp, n_mp)
    return Mesh(grid, (DP_AXIS, MP_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_points(mesh: Mesh) -> NamedSharding:
    """(n, 8) point arrays: rows over dp, replicated over mp."""
    return NamedSharding(mesh, P(DP_AXIS, None))


def psum_pytree(tree, axis_name):
    """psum every leaf of a pytree over the named axis (or axes)."""
    return jax.tree_util.tree_map(
        lambda x: jax.lax.psum(x, axis_name), tree
    )
