"""Pose-graph optimization (Levenberg-Marquardt on SE(3)).

No reference counterpart — this is the keyframe/pose-graph backend of the
BASELINE.json extension (configs 4-5). Graph: nodes = keyframe poses,
edges = relative-pose measurements (odometry chain + loop closures, both
produced by the ICP engine). Residual per edge (i, j) with measurement
Z (= measured pose_i^-1 * pose_j):

    r_ij = log( Z^-1 * X_i^-1 * X_j )   in R^6  ([rho, phi])

Levenberg-Marquardt with analytic-free Jacobians via ``jax.jacfwd`` over the
per-edge residual (6x6 blocks; tiny). Damping is ADAPTIVE with an in-scan
accept/reject: a candidate step is kept only if it lowers the (finite) total
cost, else the trust region shrinks (lambda x10) and the next iteration
re-linearizes at the same point. Plain GN with a fixed tiny damping is NOT
safe on loop-closure graphs — on a 600-node circle graph with 50-node loop
closures the first undamped step overshoots by meters and the scan diverges
to NaN. The accept/reject is a pair of jnp.where selects, so the whole
optimizer stays one fused lax.scan with no host syncs.

Two inner solvers:
  * dense 6N x 6N normal system (``optimize``) — right-sized for 10^1-10^2
    node graphs, one dense solve;
  * matrix-free block-Jacobi PCG (``optimize_pcg``) — O(E) memory per Hv
    product, scales to 10^3+ nodes.
Both have edge-sharded distributed variants (``make_sharded_optimize``,
``make_sharded_optimize_pcg``) that compute per-edge partials shard-locally
and combine with psum over the dp axis (SURVEY.md §2.6 collectives recipe).

Edges are stored as arrays (struct-of-arrays) so the whole optimizer jits
with static node/edge counts.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from icp_tpu.slam import se3

# LM trust-region schedule. Reject multiplies lambda by _LM_UP (fast escape
# from an overshooting step), accept multiplies by _LM_DOWN (gentle enough
# not to oscillate). Lambda is dimensionless: it scales diag(H) (Marquardt
# scaling), so the same schedule works across graph scales/units.
_LM_UP = 10.0
_LM_DOWN = 1.0 / 3.0
_LM_MIN = 1e-9
_LM_MAX = 1e8
# Floor for the Marquardt diagonal: padded/edge-free nodes have diag(H)=0;
# the floor makes their damped update exactly -b/lam = 0 (b is 0 there too).
_DIAG_FLOOR = 1e-3


class PoseGraph(NamedTuple):
    """Struct-of-arrays pose graph.

    Attributes:
      q: (N, 4) node orientations.
      t: (N, 3) node positions.
      edge_i: (E,) source node index.
      edge_j: (E,) target node index.
      meas_q: (E, 4) measured relative orientation (i_from_j convention:
        Z = X_i^-1 X_j).
      meas_t: (E, 3) measured relative translation.
      weight: (E,) scalar information weight per edge (e.g. ICP iteration
        count / residual based).
    """

    q: jnp.ndarray
    t: jnp.ndarray
    edge_i: jnp.ndarray
    edge_j: jnp.ndarray
    meas_q: jnp.ndarray
    meas_t: jnp.ndarray
    weight: jnp.ndarray


def graph_from_poses(poses_q, poses_t, edges, meas, weights=None) -> PoseGraph:
    """Build a PoseGraph from lists/arrays (host-side convenience)."""
    import numpy as np

    edge_i = jnp.asarray(np.asarray([e[0] for e in edges], np.int32))
    edge_j = jnp.asarray(np.asarray([e[1] for e in edges], np.int32))
    meas_q = jnp.stack([m.q for m in meas])
    meas_t = jnp.stack([m.t for m in meas])
    w = (jnp.ones((len(edges),), jnp.float32) if weights is None
         else jnp.asarray(weights))
    return PoseGraph(jnp.stack(list(poses_q)), jnp.stack(list(poses_t)),
                     edge_i, edge_j, meas_q, meas_t, w)


def demo_ring_graph(n_nodes: int = 96, n_loops: int = 12, span: int = 24,
                    radius: float = 400.0, seed: int = 3) -> PoseGraph:
    """Deterministic loop-closure ring graph (shared test/driver fixture).

    A circle of ``n_nodes`` poses with noisy odometry edges plus
    ``span``-node loop closures; the initial guess is the odometry chain
    (drifted). Every consumer that must build the IDENTICAL graph without
    sharing arrays — e.g. the processes of the multi-process dry run —
    calls this with the same arguments.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    ts = np.stack([[radius * np.cos(2 * np.pi * i / n_nodes), 0.0,
                    radius * np.sin(2 * np.pi * i / n_nodes)]
                   for i in range(n_nodes)]).astype(np.float32)
    gt = [se3.Pose(jnp.asarray(np.array([0, 0, 0, 1], np.float32)),
                   jnp.asarray(ts[i])) for i in range(n_nodes)]
    edges = [(i, i + 1) for i in range(n_nodes - 1)]
    edges += [(int(i), int(i) + span)
              for i in rng.integers(0, n_nodes - span - 1, n_loops)]
    meas = []
    for (i, j) in edges:
        xi = np.concatenate([rng.normal(0, 0.5, 3),
                             0.05 * np.pi / 180 * rng.normal(0, 1, 3)])
        meas.append(se3.compose(se3.exp(jnp.asarray(xi.astype(np.float32))),
                                se3.relative(gt[i], gt[j])))
    init = [se3.Pose.identity()]
    for k in range(n_nodes - 1):
        init.append(se3.compose(init[-1], meas[k]))
    return graph_from_poses([p.q for p in init], [p.t for p in init],
                            edges, meas)


def edge_residual(xi_i, xi_j, pose_i: se3.Pose, pose_j: se3.Pose,
                  meas: se3.Pose) -> jnp.ndarray:
    """Residual of one edge, parameterized by local updates xi around the
    current linearization points (left-multiplicative retraction)."""
    Xi = se3.retract(pose_i, xi_i)
    Xj = se3.retract(pose_j, xi_j)
    return se3.log(se3.compose(se3.inverse(meas),
                               se3.compose(se3.inverse(Xi), Xj)))


def _edge_jacobians(pose_i: se3.Pose, pose_j: se3.Pose, meas: se3.Pose):
    """(r0 (6,), Ji (6, 6), Jj (6, 6)) at xi = 0 via forward-mode autodiff."""
    zero = jnp.zeros((6,), pose_i.t.dtype)
    r0 = edge_residual(zero, zero, pose_i, pose_j, meas)
    Ji = jax.jacfwd(lambda xi: edge_residual(xi, zero, pose_i, pose_j, meas))(zero)
    Jj = jax.jacfwd(lambda xj: edge_residual(zero, xj, pose_i, pose_j, meas))(zero)
    return r0, Ji, Jj


def _residuals(graph: PoseGraph, q, t) -> jnp.ndarray:
    """(E, 6) edge residuals at the given node poses."""
    poses_i = se3.Pose(q[graph.edge_i], t[graph.edge_i])
    poses_j = se3.Pose(q[graph.edge_j], t[graph.edge_j])
    meas = se3.Pose(graph.meas_q, graph.meas_t)
    zero = jnp.zeros((6,), t.dtype)
    return jax.vmap(lambda pi, pj, m: edge_residual(zero, zero, pi, pj, m))(
        poses_i, poses_j, meas)


def _cost(graph: PoseGraph, q, t) -> jnp.ndarray:
    r = _residuals(graph, q, t)
    return jnp.sum(r * r * graph.weight[:, None])


def _assemble_system(graph: PoseGraph, q, t, n: int):
    """Shared GN normal-system assembly: (H (n,6,n,6), b (n,6), cost).

    Used by both the single-device and edge-sharded optimizers (the latter
    psums H/b afterward)."""
    poses_i = se3.Pose(q[graph.edge_i], t[graph.edge_i])
    poses_j = se3.Pose(q[graph.edge_j], t[graph.edge_j])
    meas = se3.Pose(graph.meas_q, graph.meas_t)

    r0, Ji, Jj = jax.vmap(_edge_jacobians)(poses_i, poses_j, meas)
    w = graph.weight[:, None, None]

    hi = jax.lax.Precision.HIGHEST
    Hii = jnp.matmul(jnp.swapaxes(Ji, 1, 2), Ji * w, precision=hi)
    Hjj = jnp.matmul(jnp.swapaxes(Jj, 1, 2), Jj * w, precision=hi)
    Hij = jnp.matmul(jnp.swapaxes(Ji, 1, 2), Jj * w, precision=hi)
    bi = jnp.einsum("ekr,ek->er", Ji * w[..., 0:1], r0, precision=hi)
    bj = jnp.einsum("ekr,ek->er", Jj * w[..., 0:1], r0, precision=hi)

    H = jnp.zeros((n, 6, n, 6), q.dtype)
    H = H.at[graph.edge_i, :, graph.edge_i, :].add(Hii)
    H = H.at[graph.edge_j, :, graph.edge_j, :].add(Hjj)
    H = H.at[graph.edge_i, :, graph.edge_j, :].add(Hij)
    H = H.at[graph.edge_j, :, graph.edge_i, :].add(jnp.swapaxes(Hij, 1, 2))
    b = jnp.zeros((n, 6), q.dtype)
    b = b.at[graph.edge_i].add(bi)
    b = b.at[graph.edge_j].add(bj)
    cost = jnp.sum(r0 * r0 * graph.weight[:, None])
    return H, b, cost


def _solve_dense(H, b, n: int, lam, fix_first: bool):
    """Dense gauge-anchored LM solve: dx = -(H + lam*diag(H))^-1 b.

    Marquardt scaling (lambda scales the diagonal of H, floored) makes
    lambda dimensionless and keeps padded zero-diagonal nodes exactly
    stationary."""
    Hf = H.reshape(6 * n, 6 * n)
    bf = b.reshape(6 * n)
    # Marquardt scale from diagonal(H) BEFORE the gauge anchor — the anchor
    # enters the system separately, not the scale (mirrors the PCG path's
    # _finish_precond; with the anchor included node 0 would receive an
    # extra lam*1e12 damping term, up to 1e20 near f32 range).
    d = jnp.maximum(jnp.diagonal(Hf), _DIAG_FLOOR)
    if fix_first:
        anchor = jnp.zeros((6 * n,), H.dtype).at[:6].set(1e12)
        Hf = Hf + jnp.diag(anchor)
    Hf = Hf + lam * jnp.diag(d)
    return -jnp.linalg.solve(Hf, bf).reshape(n, 6)


def _retract_all(q, t, dx):
    new = jax.vmap(lambda qq, tt, xi: se3.retract(se3.Pose(qq, tt), xi))(
        q, t, dx)
    return new.q, new.t


def _lm_select(ok, q_new, t_new, q, t, lam):
    """Accept/reject select shared by every LM loop (two wheres + the
    lambda schedule)."""
    q = jnp.where(ok, q_new, q)
    t = jnp.where(ok, t_new, t)
    lam = jnp.clip(jnp.where(ok, lam * _LM_DOWN, lam * _LM_UP),
                   _LM_MIN, _LM_MAX)
    return q, t, lam


@partial(jax.jit, static_argnames=("iterations", "fix_first"))
def optimize(graph: PoseGraph, iterations: int = 10,
             damping: float = 1e-4, fix_first: bool = True) -> PoseGraph:
    """Levenberg-Marquardt pose-graph optimization (dense inner solve).

    The first node is gauge-fixed (anchored) by default. Builds the dense
    6N x 6N normal system with vmapped 6x6 blocks scattered via
    segment-sum-style index_add, solves with LU-backed ``solve``; a
    candidate step is accepted only if it lowers the finite total cost
    (see module docstring — plain GN diverges on loop-closure graphs).
    ``damping`` is the initial dimensionless lambda.
    """
    n = graph.q.shape[0]

    def lm_iter(carry, _):
        q, t, lam = carry
        H, b, cost = _assemble_system(graph, q, t, n)
        dx = _solve_dense(H, b, n, lam, fix_first)
        q_new, t_new = _retract_all(q, t, dx)
        new_cost = _cost(graph, q_new, t_new)
        ok = jnp.isfinite(new_cost) & (new_cost < cost)
        return _lm_select(ok, q_new, t_new, q, t, lam), cost

    lam0 = jnp.asarray(damping, graph.t.dtype)
    (q, t, _), _costs = jax.lax.scan(
        lm_iter, (graph.q, graph.t, lam0), None, length=iterations)
    return graph._replace(q=q, t=t)


def _edge_partials(graph: PoseGraph, q, t):
    """Per-edge linearization (r0, Ji, Jj) and the gradient b = J^T W r
    scattered to nodes — shared by the PCG path."""
    poses_i = se3.Pose(q[graph.edge_i], t[graph.edge_i])
    poses_j = se3.Pose(q[graph.edge_j], t[graph.edge_j])
    meas = se3.Pose(graph.meas_q, graph.meas_t)
    r0, Ji, Jj = jax.vmap(_edge_jacobians)(poses_i, poses_j, meas)
    hi = jax.lax.Precision.HIGHEST
    wr = r0 * graph.weight[:, None]
    n = q.shape[0]
    b = jnp.zeros((n, 6), q.dtype)
    b = b.at[graph.edge_i].add(
        jnp.einsum("ekr,ek->er", Ji, wr, precision=hi))
    b = b.at[graph.edge_j].add(
        jnp.einsum("ekr,ek->er", Jj, wr, precision=hi))
    return r0, Ji, Jj, b


def _hvp_local(graph: PoseGraph, Ji, Jj, n: int):
    """Matrix-free J^T W J v product over THIS shard's edges — no damping
    or anchor terms (the caller adds those once, after any psum).

    One gather + two batched (E, 6, 6) x (E, 6) products + one scatter-add
    per application — O(E) memory instead of the dense path's O(36 N^2)."""
    hi = jax.lax.Precision.HIGHEST
    w = graph.weight[:, None]

    def hvp(v):
        yi = jnp.einsum("ekr,er->ek", Ji, v[graph.edge_i], precision=hi)
        yj = jnp.einsum("ekr,er->ek", Jj, v[graph.edge_j], precision=hi)
        wy = (yi + yj) * w
        out = jnp.zeros((n, 6), v.dtype)
        out = out.at[graph.edge_i].add(
            jnp.einsum("ekr,ek->er", Ji, wy, precision=hi))
        out = out.at[graph.edge_j].add(
            jnp.einsum("ekr,ek->er", Jj, wy, precision=hi))
        return out

    return hvp


def _diag_blocks(graph: PoseGraph, Ji, Jj, n: int):
    """Diagonal 6x6 blocks of J^T W J over this shard's edges (no damping)."""
    hi = jax.lax.Precision.HIGHEST
    w = graph.weight[:, None, None]
    Hii = jnp.matmul(jnp.swapaxes(Ji, 1, 2), Ji * w, precision=hi)
    Hjj = jnp.matmul(jnp.swapaxes(Jj, 1, 2), Jj * w, precision=hi)
    D = jnp.zeros((n, 6, 6), Ji.dtype)
    D = D.at[graph.edge_i].add(Hii)
    D = D.at[graph.edge_j].add(Hjj)
    return D


def _finish_precond(D, lam, anchor):
    """From the (global) diagonal blocks D: the Marquardt diagonal scale
    dscale (n, 6) and the damped+anchored block-Jacobi inverse Minv."""
    n = D.shape[0]
    dscale = jnp.maximum(
        jnp.diagonal(D, axis1=1, axis2=2), _DIAG_FLOOR)  # (n, 6)
    eye = jnp.eye(6, dtype=D.dtype)
    Dd = D + lam * jax.vmap(jnp.diag)(dscale)
    Dd = Dd.at[0].add(anchor * eye)
    # dscale excludes the anchor: it enters the hvp separately, not the scale.
    return dscale, jnp.linalg.inv(Dd)


def _pcg(hvp, Minv, b, iters: int):
    """Fixed-iteration preconditioned CG for H x = -b (x0 = 0). A static
    trip count keeps the whole solve one fused lax.scan — no host syncs or
    data-dependent control flow; a residual-based early
    exit would buy nothing at these sizes."""
    apply_M = lambda r: jnp.einsum("nij,nj->ni", Minv, r)
    x0 = jnp.zeros_like(b)
    r0 = -b  # residual of H x + b at x = 0
    z0 = apply_M(r0)
    p0 = z0

    def body(carry, _):
        x, r, z, p = carry
        Hp = hvp(p)
        rz = jnp.sum(r * z)
        denom = jnp.sum(p * Hp)
        alpha = rz / jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
        x = x + alpha * p
        r_new = r - alpha * Hp
        z_new = apply_M(r_new)
        beta = jnp.sum(r_new * z_new) / jnp.where(jnp.abs(rz) > 1e-30, rz, 1.0)
        p = z_new + beta * p
        return (x, r_new, z_new, p), None

    (x, *_), _ = jax.lax.scan(body, (x0, r0, z0, p0), None, length=iters)
    return x


@partial(jax.jit, static_argnames=("iterations", "cg_iterations",
                                   "fix_first"))
def optimize_pcg(graph: PoseGraph, iterations: int = 10,
                 cg_iterations: int = 32, damping: float = 1e-4,
                 fix_first: bool = True,
                 anchor_weight: float = 1e6) -> PoseGraph:
    """Levenberg-Marquardt with a matrix-free PCG inner solve.

    Scales past the dense path's ~10^3-node limit (ROADMAP item): memory is
    O(E) per Hv product instead of O(36 N^2) for the assembled H, and each
    CG iteration is gather + batched 6x6 matvecs + scatter-add — all
    batched with static shapes. Block-Jacobi preconditioning keeps
    CG iteration counts low on chain+loop graphs. Same adaptive-lambda
    accept/reject as :func:`optimize`.
    """
    n = graph.q.shape[0]
    anchor = anchor_weight if fix_first else 0.0

    def lm_iter(carry, _):
        q, t, lam = carry
        r0, Ji, Jj, b = _edge_partials(graph, q, t)
        cost = jnp.sum(r0 * r0 * graph.weight[:, None])
        D = _diag_blocks(graph, Ji, Jj, n)
        dscale, Minv = _finish_precond(D, lam, anchor)
        raw = _hvp_local(graph, Ji, Jj, n)
        hvp = lambda v: (raw(v) + lam * dscale * v).at[0].add(anchor * v[0])
        dx = _pcg(hvp, Minv, b, cg_iterations)
        q_new, t_new = _retract_all(q, t, dx)
        new_cost = _cost(graph, q_new, t_new)
        ok = jnp.isfinite(new_cost) & (new_cost < cost)
        return _lm_select(ok, q_new, t_new, q, t, lam), None

    lam0 = jnp.asarray(damping, graph.t.dtype)
    (q, t, _), _ = jax.lax.scan(lm_iter, (graph.q, graph.t, lam0), None,
                                length=iterations)
    return graph._replace(q=q, t=t)


def pad_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge arrays to a multiple (for even dp sharding) with
    zero-weight identity self-edges on node 0 — they contribute nothing."""
    e = graph.edge_i.shape[0]
    target = ((e + multiple - 1) // multiple) * multiple
    pad = target - e
    if pad == 0:
        return graph
    zq = jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0], graph.q.dtype), (pad, 1))
    zt = jnp.zeros((pad, 3), graph.t.dtype)
    return graph._replace(
        edge_i=jnp.concatenate([graph.edge_i, jnp.zeros((pad,), jnp.int32)]),
        edge_j=jnp.concatenate([graph.edge_j, jnp.zeros((pad,), jnp.int32)]),
        meas_q=jnp.concatenate([graph.meas_q, zq]),
        meas_t=jnp.concatenate([graph.meas_t, zt]),
        weight=jnp.concatenate([graph.weight,
                                jnp.zeros((pad,), graph.weight.dtype)]),
    )


def pad_nodes(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the node arrays to a multiple with identity poses touched by no
    edge — their normal-equation block is damping-only, so their update is
    exactly zero and the solve over real nodes is unaffected. Bounds jit
    recompiles of the optimizers to one graph per padded size (the
    incremental-smoothing path calls the optimizer once per loop closure)."""
    n = graph.q.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    pad = target - n
    if pad == 0:
        return graph
    iq = jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0], graph.q.dtype), (pad, 1))
    it = jnp.zeros((pad, 3), graph.t.dtype)
    return graph._replace(q=jnp.concatenate([graph.q, iq]),
                          t=jnp.concatenate([graph.t, it]))


def _edge_specs(P, axis):
    """PoseGraph PartitionSpec pytree: poses replicated, edge arrays
    sharded over ``axis``."""
    return PoseGraph(q=P(), t=P(),
                     edge_i=P(axis), edge_j=P(axis),
                     meas_q=P(axis), meas_t=P(axis), weight=P(axis))


def make_sharded_optimize(mesh, n_nodes: int, iterations: int = 10,
                          damping: float = 1e-4, fix_first: bool = True):
    """Distributed pose-graph LM: EDGES sharded over dp (keyframe residuals
    computed shard-locally), dense normal-system partials combined by ONE
    psum per iteration, replicated solve/update — the same
    partials+collectives recipe as the sharded ICP step and BA
    (SURVEY.md §2.6). Poses are replicated (the keyframe set is small; the
    work scales with edges). Candidate costs are psummed so every shard
    takes the same accept/reject branch.

    Returns ``run(graph) -> PoseGraph`` for a graph whose edge arrays are
    evenly divisible by the dp size (see :func:`pad_edges`).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from icp_tpu.parallel.mesh import DP_AXIS

    n = n_nodes

    def lm_local(graph: PoseGraph) -> PoseGraph:
        def lm_iter(carry, _):
            q, t, lam = carry
            H, b, cost = _assemble_system(graph, q, t, n)
            # Combine shard partials — one fused psum per iteration.
            H, b, cost = jax.lax.psum((H, b, cost), DP_AXIS)
            dx = _solve_dense(H, b, n, lam, fix_first)
            q_new, t_new = _retract_all(q, t, dx)
            new_cost = jax.lax.psum(_cost(graph, q_new, t_new), DP_AXIS)
            ok = jnp.isfinite(new_cost) & (new_cost < cost)
            return _lm_select(ok, q_new, t_new, q, t, lam), None

        lam0 = jnp.asarray(damping, graph.t.dtype)
        (q, t, _), _ = jax.lax.scan(lm_iter, (graph.q, graph.t, lam0), None,
                                    length=iterations)
        return graph._replace(q=q, t=t)

    spec = _edge_specs(P, DP_AXIS)
    sharded = shard_map(lm_local, mesh=mesh, in_specs=(spec,),
                        out_specs=spec, check_vma=False)
    return jax.jit(sharded)


def make_sharded_optimize_pcg(mesh, n_nodes: int, iterations: int = 10,
                              cg_iterations: int = 32, damping: float = 1e-4,
                              fix_first: bool = True,
                              anchor_weight: float = 1e6):
    """Distributed matrix-free LM-PCG: edges sharded over dp, poses
    replicated. Per LM iteration the shards psum the gradient b, the
    block-diagonal preconditioner blocks, and both costs; each CG iteration
    psums one (n, 6) Hv partial — O(n) bytes on the wire instead of the
    dense path's O(36 n^2) H psum, which is what makes 10^3+-node maps
    shardable at all (dense H at n=600 is a 51 MB psum per iteration).

    Returns ``run(graph) -> PoseGraph``; pad edges to the dp size first
    (:func:`pad_edges`).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from icp_tpu.parallel.mesh import DP_AXIS

    n = n_nodes
    anchor = anchor_weight if fix_first else 0.0

    def lm_local(graph: PoseGraph) -> PoseGraph:
        def lm_iter(carry, _):
            q, t, lam = carry
            r0, Ji, Jj, b_loc = _edge_partials(graph, q, t)
            cost_loc = jnp.sum(r0 * r0 * graph.weight[:, None])
            D_loc = _diag_blocks(graph, Ji, Jj, n)
            b, D, cost = jax.lax.psum((b_loc, D_loc, cost_loc), DP_AXIS)
            dscale, Minv = _finish_precond(D, lam, anchor)
            raw = _hvp_local(graph, Ji, Jj, n)
            # Only the J^T W J partial crosses shards; damping/anchor are
            # replicated terms added once after the psum.
            hvp = lambda v: (jax.lax.psum(raw(v), DP_AXIS)
                             + lam * dscale * v).at[0].add(anchor * v[0])
            dx = _pcg(hvp, Minv, b, cg_iterations)
            q_new, t_new = _retract_all(q, t, dx)
            new_cost = jax.lax.psum(_cost(graph, q_new, t_new), DP_AXIS)
            ok = jnp.isfinite(new_cost) & (new_cost < cost)
            return _lm_select(ok, q_new, t_new, q, t, lam), None

        lam0 = jnp.asarray(damping, graph.t.dtype)
        (q, t, _), _ = jax.lax.scan(lm_iter, (graph.q, graph.t, lam0), None,
                                    length=iterations)
        return graph._replace(q=q, t=t)

    spec = _edge_specs(P, DP_AXIS)
    sharded = shard_map(lm_local, mesh=mesh, in_specs=(spec,),
                        out_specs=spec, check_vma=False)
    return jax.jit(sharded)


def graph_cost(graph: PoseGraph) -> jnp.ndarray:
    """Total weighted squared residual of the graph (diagnostic)."""
    return _cost(graph, graph.q, graph.t)
