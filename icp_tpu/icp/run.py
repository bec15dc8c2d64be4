"""Iterate-to-convergence driver — the reference's ``ICP<CR, CW>`` class.

The reference loop runs on the host: ``run()`` = first step +
``while (check()) step`` + queue.finish (src/ICP/algorithms.cpp:4806-4814),
with ``check()`` stopping at ``max_iterations`` or when the incremental
rotation angle and translation both drop below their thresholds
(cpp:4823-4834). Here the loop is a ``lax.while_loop`` INSIDE jit: the
entire registration — up to 40 iterations of search + reduction + rotation
solve — is one device dispatch with no host synchronization at all, which is
the key structural win over the reference (SURVEY.md §3.1).
"""

from __future__ import annotations

from functools import partial
from typing import Union

import jax
import jax.numpy as jnp

from icp_tpu.icp.quaternion import qangle_deg
from icp_tpu.icp.state import ICPState, identity_state
from icp_tpu.icp.step import BruteTarget, icp_step
from icp_tpu.ops.sampling import sample_representative_indices
from icp_tpu.rbc.construct import RBCIndex, rbc_construct
from icp_tpu.runtime.config import Correspondence, ICPConfig, ICPParams, Objective


def converged(state: ICPState, params: ICPParams) -> jnp.ndarray:
    """Reference ``ICP::check`` convergence test (cpp:4823-4834).

    delta_angle = 180/pi * 2 * atan2(|qk_vec|, qk_w) in degrees;
    delta_translation = |t_k|. Converged when both are below threshold.
    """
    delta_angle = qangle_deg(state.qk)
    delta_t = jnp.linalg.norm(state.tk)
    return jnp.logical_and(
        delta_angle < params.angle_threshold_deg,
        delta_t < params.translation_threshold,
    )


def icp_run(moving8: jnp.ndarray, target: Union[RBCIndex, jnp.ndarray],
            params: ICPParams, config: ICPConfig,
            init: ICPState | None = None) -> ICPState:
    """Run ICP to convergence (device-resident loop).

    Semantics match the reference: at least one iteration; stop after
    ``max_iterations`` total or when the last increment is below both
    thresholds.
    """
    state = identity_state(moving8.dtype) if init is None else init

    # The moving cloud's normals (symmetric-plane / GICP side channel) are
    # loop-invariant: estimate them ONCE here, not in every body iteration
    # (XLA does not hoist the kNN estimator's eigh/map out of the loop —
    # recomputing it in-body would repeat it every iteration).
    if (config.objective is Objective.GICP
            or (config.objective is Objective.PLANE
                and config.plane_symmetric)):
        from icp_tpu.ops.normals import normals_for

        mnormals = normals_for(moving8, config.normal_mode)
    else:
        mnormals = None

    # The convergence test runs INSIDE the body (fused into the iteration's
    # epilogue) and rides the carry as a boolean, so the while_loop's cond
    # is pure scalar logic on carried values. Evaluated in the cond instead,
    # the qangle/norm/compare chain becomes its own run of tiny kernel
    # launches between iterations. Semantics are identical: the flag is
    # computed from exactly the state the cond would have tested.
    def cond(carry):
        s, done = carry
        return jnp.logical_and(s.k < config.max_iterations,
                               jnp.logical_or(s.k == 0,
                                              jnp.logical_not(done)))

    def body(carry):
        s, _ = carry
        ns = icp_step(s, moving8, target, params, config,
                      moving_normals=mnormals)
        return ns, converged(ns, params)

    # NOTE: a warm-start grouping cache in the loop carry (skip the
    # grouping sort + gathers via lax.cond when the rep assignments are
    # unchanged) lost on the previous accelerator: the cond + big carried
    # tables defeated buffer donation. Not measured on the GPU.
    final, _ = jax.lax.while_loop(cond, body, (state, jnp.bool_(False)))
    return final


def build_index(fixed8: jnp.ndarray, params: ICPParams,
                config: ICPConfig) -> RBCIndex:
    """Representative sampling + RBC construction over the fixed landmarks.

    Mirrors ``ICPStep::buildRBC`` = fReps.run() + rbcC.run()
    (reference cpp:3445-3450).
    """
    rep_ids = sample_representative_indices(fixed8.shape[0], config.n_r,
                                            config.rep_grid)
    reps = fixed8[rep_ids]
    if config.needs_normals:
        from icp_tpu.ops.normals import normals_for

        normals = normals_for(fixed8, config.normal_mode)
    else:
        normals = None
    return rbc_construct(fixed8, reps, params.alpha, config.bin_capacity,
                         rep_db_ids=rep_ids, normals=normals)


@partial(jax.jit, static_argnames=("config",))
def register(fixed8: jnp.ndarray, moving8: jnp.ndarray,
             params: ICPParams, config: ICPConfig) -> ICPState:
    """Full registration entry point — the ``ICPReg::registerPC`` equivalent
    (reference src/ocl_icp_reg.cpp:165-207): build the RBC over the fixed
    landmarks, run ICP to convergence, return the accumulated transform.

    One jit dispatch end to end.
    """
    if config.correspondence is Correspondence.RBC:
        target: Union[RBCIndex, BruteTarget, jnp.ndarray] = build_index(
            fixed8, params, config)
    elif config.needs_normals:
        # Brute + plane/GICP needs only the normals, not the full RBC
        # structure.
        from icp_tpu.ops.normals import normals_for

        target = BruteTarget(
            db=fixed8, normals=normals_for(fixed8, config.normal_mode))
    else:
        target = fixed8
    return icp_run(moving8, target, params, config)


@partial(jax.jit, static_argnames=("config",))
def register_batch(fixed8: jnp.ndarray, moving8: jnp.ndarray,
                   params: ICPParams, config: ICPConfig) -> ICPState:
    """Register a BATCH of pairs in one dispatch (beyond-reference:
    serving/offline throughput — multi-camera rigs, map-merging queues,
    trajectory re-verification).

    ``vmap`` over :func:`register`: RBC construction, the search kernels,
    and the reductions all batch; the convergence ``while_loop`` becomes a
    batched loop that runs until EVERY pair converges, with already-
    converged pairs frozen by the batching rule's select — so each lane's
    result (including its iteration count ``k``) is exactly the
    single-pair result. Wall-clock is set by the slowest pair, but the
    dispatch amortization across lanes is what throughput serving on one
    card wants.

    Args:
      fixed8: (B, m, 8) fixed landmark sets.
      moving8: (B, m, 8) moving landmark sets.
      params: dynamic scalars, shared across the batch.
      config: static configuration, shared across the batch.
    Returns:
      ICPState with a leading batch axis on every leaf.
    """
    return jax.vmap(lambda f, m: register(f, m, params, config))(
        fixed8, moving8)
