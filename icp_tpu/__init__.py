"""icp_tpu — photogeometric ICP / RGB-D SLAM framework for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of nlamprian/ICP
(OpenCL photogeometric Iterative Closest Point for real-time RGB-D
registration, per Neumann et al., "Real-time RGB-D mapping and 3-D modeling
on the GPU using the random ball cover data structure").

Points are 8-D: 4-D homogeneous geometry (x, y, z, 1) + 4-D photometric
(r, g, b, 1), stored as ``(n, 8)`` float32 arrays.

Layer map (vs the reference's six layers, see SURVEY.md §1):

    reference L0 CLEnv/queues          -> icp_tpu.runtime  (mesh/device setup, timing)
    reference L1 OpenCL kernels        -> icp_tpu.ops + icp_tpu.rbc (XLA) + icp_tpu.kernels (Pallas-Triton)
    reference L2 kernel classes        -> jitted functions in icp_tpu.ops
    reference RBC external dep         -> icp_tpu.rbc (construct/search)
    reference L3 ICPStep/ICP           -> icp_tpu.icp (step + lax.while_loop driver)
    reference L4/L5 apps               -> icp_tpu.sensors + icp_tpu.slam + examples
    (no reference counterpart)         -> icp_tpu.parallel (mesh sharding, collectives)
"""

from icp_tpu.runtime.config import (
    ICPConfig,
    ICPParams,
    Objective,
    RobustKernel,
    RotationMode,
    Weighting,
    Correspondence,
)
from icp_tpu.icp.state import ICPState, identity_state
from icp_tpu.icp.step import icp_step
from icp_tpu.icp.run import icp_run, register, register_batch
from icp_tpu.rbc.construct import rbc_construct, RBCIndex
from icp_tpu.rbc.search import rbc_search

__version__ = "0.1.0"

__all__ = [
    "ICPConfig",
    "ICPParams",
    "Objective",
    "RobustKernel",
    "RotationMode",
    "Weighting",
    "Correspondence",
    "ICPState",
    "identity_state",
    "icp_step",
    "icp_run",
    "register",
    "register_batch",
    "rbc_construct",
    "rbc_search",
    "RBCIndex",
    "__version__",
]
