"""Keyframe mapping engine: odometry + loop closure + pose-graph backend.

BASELINE.json configs 4-5 (no reference counterpart — the reference stops at
single-pair registration). The engine consumes frames, chains ICP odometry,
promotes keyframes, detects loop closures by pose proximity verified with a
full ICP registration, and refines the trajectory with the pose-graph
optimizer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icp_tpu.icp.quaternion import qangle_deg
from icp_tpu.icp.run import register
from icp_tpu.runtime.config import ICPConfig, ICPParams
from icp_tpu.slam import se3
from icp_tpu.slam.odometry import KeyframePolicy, frame_to_landmarks
from icp_tpu.slam.pose_graph import PoseGraph, graph_from_poses, optimize


@dataclass
class Keyframe:
    """A map node: pose estimate + its landmark cloud."""

    index: int  # frame index it came from
    pose: se3.Pose  # world_from_camera estimate
    landmarks: jnp.ndarray  # (m, 8) camera-frame landmarks


@dataclass(frozen=True)
class LoopClosureConfig:
    """Loop-closure candidate gating + acceptance.

    A keyframe pair is a candidate when their estimated poses are within
    ``max_distance`` translation and ``max_angle_deg`` rotation but at least
    ``min_gap`` keyframes apart; the candidate is verified by a full ICP
    registration and accepted when ICP converges within
    ``max_iterations_accept`` iterations (non-convergent registrations are
    unreliable matches).
    """

    max_distance: float = 300.0  # mm
    max_angle_deg: float = 15.0
    min_gap: int = 3
    max_iterations_accept: int = 39
    # Pad every verification batch UP to this size (still pow2-rounded
    # above it). 0 keeps pure pow2 padding. Where compiles are expensive,
    # a single fixed batch size means ONE vmapped-register compile for the
    # whole session instead of log2-many; the padded lanes repeat a real candidate and
    # cost microseconds of device time each.
    verify_pad_to: int = 0


@dataclass
class SlamMap:
    """The map: keyframes + pose-graph edges."""

    keyframes: List[Keyframe] = field(default_factory=list)
    edges: List[Tuple[int, int]] = field(default_factory=list)  # kf indices
    measurements: List[se3.Pose] = field(default_factory=list)
    weights: List[float] = field(default_factory=list)
    loop_closures: List[Tuple[int, int]] = field(default_factory=list)


class SlamEngine:
    """Frame-in, trajectory-out SLAM driver."""

    def __init__(self, params: Optional[ICPParams] = None,
                 config: Optional[ICPConfig] = None,
                 policy: KeyframePolicy = KeyframePolicy(),
                 loop_config: LoopClosureConfig = LoopClosureConfig(),
                 use_pyramid: bool = False,
                 pyramid_strides: tuple = (4, 2, 1),
                 dispatch_retries: int = 0,
                 incremental_optimize: bool = False,
                 incremental_iterations: int = 3):
        """Args of note:
          incremental_optimize: iSAM-style incremental smoothing — run
            ``incremental_iterations`` warm-started Gauss-Newton iterations
            of the pose-graph backend immediately after every accepted loop
            closure, instead of deferring all correction to a final
            ``optimize_map``. Each update starts from the current pose
            estimates (the previous update's output), so the per-closure
            cost stays small and the trajectory never drifts far from the
            smoothed solution. Graph shapes are padded (nodes to powers of
            two, edges to multiples of 64) so device recompiles stay
            O(log K) over a session.
          use_pyramid: run frame-to-frame registrations coarse-to-fine
            (icp_tpu.icp.pyramid) — wider convergence basin for fast motion
            / dropped frames, at ~1.3x the per-frame cost. Loop-closure
            verification always uses the pyramid when enabled (closure
            candidates have the largest pose error by construction).
          dispatch_retries: bounded retries (parallel.resilience) around
            each PURE registration dispatch. Retrying here is safe; wrapping
            ``process_frame`` from outside is NOT (it mutates engine state —
            trajectory append, keyframes — before its last dispatch, so an
            outer retry would duplicate the frame).
        """
        self.params = (params or ICPParams(alpha=2e2)).as_f32()
        # Rigid mode: scale drift compounds over a trajectory.
        self.config = config or ICPConfig(estimate_scale=False)
        self.policy = policy
        self.loop_config = loop_config
        self.use_pyramid = use_pyramid
        self.pyramid_strides = pyramid_strides
        self.dispatch_retries = dispatch_retries
        self.incremental_optimize = incremental_optimize
        self.incremental_iterations = incremental_iterations
        self.n_incremental_updates = 0  # diagnostic
        self.map = SlamMap()
        self.trajectory: List[se3.Pose] = []
        self._prev_lms: Optional[jnp.ndarray] = None
        self._gap_since_kf = 0
        # Loop-closure scaling state: a grid hash over keyframe positions
        # (cell = max_distance, so every in-range candidate lives in the
        # 3^3 neighborhood) + host-side numpy pose mirrors so the gating
        # never round-trips the device, + a per-batch-size cache of
        # vmapped verification dispatches.
        self._kf_grid: dict = {}
        self._kf_pos: List[np.ndarray] = []
        self._kf_quat: List[np.ndarray] = []
        self._verify_fns: dict = {}
        self.n_pairs_verified = 0  # diagnostic: total closure ICP dispatches

    def _register(self, fixed_lms, moving_lms):
        if self.use_pyramid:
            from icp_tpu.icp.pyramid import register_pyramid

            fn = lambda f, m: register_pyramid(  # noqa: E731
                f, m, self.params, self.config, self.pyramid_strides)
        else:
            fn = lambda f, m: register(f, m, self.params, self.config)  # noqa: E731
        if self.dispatch_retries > 0:
            from icp_tpu.parallel.resilience import with_retries

            return with_retries(fn, fixed_lms, moving_lms,
                                retries=self.dispatch_retries)
        return jax.block_until_ready(fn(fixed_lms, moving_lms))

    # -- frame ingestion ----------------------------------------------------

    def process_frame(self, cloud8: jnp.ndarray) -> se3.Pose:
        """Ingest one camera-frame cloud; returns the world pose estimate."""
        lms = frame_to_landmarks(cloud8) if cloud8.ndim != 2 or \
            cloud8.shape[0] != self.config.m else cloud8

        if self._prev_lms is None:
            pose = se3.Pose.identity()
            self.trajectory.append(pose)
            self._add_keyframe(0, pose, lms)
            self._prev_lms = lms
            return pose

        state = self._register(self._prev_lms, lms)
        rel = se3.Pose(state.q, state.t)  # prev_from_cur
        pose = se3.compose(self.trajectory[-1], rel)
        self.trajectory.append(pose)
        self._prev_lms = lms

        frame_idx = len(self.trajectory) - 1
        self._gap_since_kf += 1
        last_kf = self.map.keyframes[-1]
        d = se3.relative(last_kf.pose, pose)
        if (float(qangle_deg(d.q)) > self.policy.max_angle_deg
                or float(jnp.linalg.norm(d.t)) > self.policy.max_translation
                or self._gap_since_kf >= self.policy.max_gap):
            self._add_keyframe(frame_idx, pose, lms)
        return pose

    def _add_keyframe(self, frame_idx: int, pose: se3.Pose,
                      lms: jnp.ndarray) -> None:
        kf_idx = len(self.map.keyframes)
        self.map.keyframes.append(Keyframe(frame_idx, pose, lms))
        self._gap_since_kf = 0
        if kf_idx > 0:
            prev = self.map.keyframes[kf_idx - 1]
            self.map.edges.append((kf_idx - 1, kf_idx))
            self.map.measurements.append(se3.relative(prev.pose, pose))
            self.map.weights.append(1.0)
        self._detect_loop_closures(kf_idx)
        self._grid_insert(kf_idx, pose)

    # -- loop closure -------------------------------------------------------
    #
    # Round-1 scanned EVERY prior keyframe per new keyframe with one device
    # round-trip per pose gate and one full ICP dispatch per surviving
    # candidate — O(K) gates and serial verifications, dead at 10^3
    # keyframes. Now: a grid hash over positions bounds the candidate set
    # to the spatial neighborhood, the pose gates run vectorized on
    # host-side numpy mirrors (zero device traffic), and ALL surviving
    # candidates of a keyframe verify in ONE vmapped registration dispatch
    # (batch padded to powers of two to bound recompiles).

    def _cell(self, t: np.ndarray) -> tuple:
        cs = self.loop_config.max_distance
        return (int(np.floor(t[0] / cs)), int(np.floor(t[1] / cs)),
                int(np.floor(t[2] / cs)))

    def _grid_insert(self, kf_idx: int, pose: se3.Pose) -> None:
        t = np.asarray(pose.t)
        self._kf_pos.append(t)
        self._kf_quat.append(np.asarray(pose.q))
        self._kf_grid.setdefault(self._cell(t), []).append(kf_idx)

    def _rebuild_grid(self) -> None:
        """Re-key the spatial index after poses move (optimize_map)."""
        self._kf_grid.clear()
        self._kf_pos = [np.asarray(kf.pose.t) for kf in self.map.keyframes]
        self._kf_quat = [np.asarray(kf.pose.q) for kf in self.map.keyframes]
        for i, t in enumerate(self._kf_pos):
            self._kf_grid.setdefault(self._cell(t), []).append(i)

    def _candidate_ids(self, kf_idx: int, pose: se3.Pose) -> List[int]:
        """Spatially-plausible, gap-separated, pose-gated candidates."""
        lc = self.loop_config
        t_cur = np.asarray(pose.t)
        q_cur = np.asarray(pose.q)
        cx, cy, cz = self._cell(t_cur)
        ids: List[int] = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    ids.extend(self._kf_grid.get((cx + dx, cy + dy, cz + dz),
                                                 ()))
        ids = sorted(j for j in set(ids) if j < kf_idx - lc.min_gap)
        if not ids:
            return []
        ts = np.stack([self._kf_pos[j] for j in ids])
        qs = np.stack([self._kf_quat[j] for j in ids])
        dist = np.linalg.norm(ts - t_cur, axis=1)  # |R_a^T (t_b - t_a)|
        dots = np.clip(np.abs(qs @ q_cur), 0.0, 1.0)
        ang = np.degrees(2.0 * np.arccos(dots))
        keep = (dist <= lc.max_distance) & (ang <= lc.max_angle_deg)
        return [j for j, k in zip(ids, keep) if k]

    def _verify_batch(self, fixed_stack: jnp.ndarray, moving_lms):
        """One vmapped registration dispatch over a candidate batch."""
        b = fixed_stack.shape[0]
        if b not in self._verify_fns:
            cfg, prm = self.config, self.params
            if self.use_pyramid:
                from icp_tpu.icp.pyramid import register_pyramid

                strides = self.pyramid_strides
                one = lambda f, m: register_pyramid(  # noqa: E731
                    f, m, prm, cfg, strides)
            else:
                one = lambda f, m: register(f, m, prm, cfg)  # noqa: E731
            self._verify_fns[b] = jax.jit(jax.vmap(one, in_axes=(0, None)))
        fn = self._verify_fns[b]
        if self.dispatch_retries > 0:
            from icp_tpu.parallel.resilience import with_retries

            return with_retries(fn, fixed_stack, moving_lms,
                                retries=self.dispatch_retries)
        return jax.block_until_ready(fn(fixed_stack, moving_lms))

    def _detect_loop_closures(self, kf_idx: int) -> None:
        cur = self.map.keyframes[kf_idx]
        lc = self.loop_config
        cand = self._candidate_ids(kf_idx, cur.pose)
        if not cand:
            return
        # Pad to the next power of two (bounds distinct vmap compiles to
        # log2(K) graphs); padding lanes repeat the last candidate.
        # verify_pad_to >= batch collapses that to ONE compiled graph.
        b = max(1 << (len(cand) - 1).bit_length(), lc.verify_pad_to)
        padded = cand + [cand[-1]] * (b - len(cand))
        fixed_stack = jnp.stack(
            [self.map.keyframes[j].landmarks for j in padded])
        states = self._verify_batch(fixed_stack, cur.landmarks)
        self.n_pairs_verified += len(cand)
        ks = np.asarray(states.k)
        qs = np.asarray(states.q)
        ts = np.asarray(states.t)
        accepted = 0
        for i, j in enumerate(cand):
            # Accept when ICP converged within the budget (non-convergent
            # registrations are unreliable matches).
            if int(ks[i]) > lc.max_iterations_accept:
                continue
            self.map.edges.append((j, kf_idx))
            self.map.measurements.append(
                se3.Pose(jnp.asarray(qs[i]), jnp.asarray(ts[i])))
            # Loop closures weighted above odometry links.
            self.map.weights.append(4.0)
            self.map.loop_closures.append((j, kf_idx))
            accepted += 1
        if accepted and self.incremental_optimize \
                and len(self.map.keyframes) >= 2:
            self._incremental_update()

    # -- backend ------------------------------------------------------------

    def optimize_map(self, iterations: int = 10,
                     use_pcg: bool | None = None) -> PoseGraph:
        """Run the pose-graph backend and write the refined poses back to
        the keyframes (and re-anchor the trajectory tail).

        ``use_pcg`` selects the matrix-free PCG solver; the default picks it
        automatically for maps beyond the dense 6N solve's comfort zone
        (> 512 keyframes)."""
        if len(self.map.keyframes) < 2:
            raise ValueError("need at least two keyframes to optimize")
        graph = graph_from_poses(
            [k.pose.q for k in self.map.keyframes],
            [k.pose.t for k in self.map.keyframes],
            self.map.edges, self.map.measurements,
            np.asarray(self.map.weights, np.float32))
        if use_pcg is None:
            use_pcg = len(self.map.keyframes) > 512
        if use_pcg:
            from icp_tpu.slam.pose_graph import optimize_pcg

            out = jax.block_until_ready(
                optimize_pcg(graph, iterations=iterations))
        else:
            out = jax.block_until_ready(optimize(graph, iterations=iterations))
        self._apply_refined(out.q, out.t)
        return out

    def _apply_refined(self, out_q, out_t) -> None:
        """Write refined keyframe poses back and re-anchor the trajectory:
        every frame between keyframe k and the next inherits k's world-frame
        correction corr_k = refined_k o old_k^-1, so ATE reporting,
        checkpoints, and odometry resume all see the optimized poses
        (keyframe frames land exactly on their refined pose)."""
        corrections = []
        for i, kf in enumerate(self.map.keyframes):
            refined = se3.Pose(out_q[i], out_t[i])
            corrections.append(se3.compose(refined, se3.inverse(kf.pose)))
            kf.pose = refined
        kf_frames = [kf.index for kf in self.map.keyframes]
        ki = 0
        for f in range(len(self.trajectory)):
            while ki + 1 < len(kf_frames) and f >= kf_frames[ki + 1]:
                ki += 1
            if f >= kf_frames[0]:
                self.trajectory[f] = se3.compose(corrections[ki],
                                                 self.trajectory[f])
        self._rebuild_grid()  # keyframe positions moved

    def _incremental_update(self) -> None:
        """A few warm-started GN iterations right after an accepted loop
        closure (iSAM-style incremental smoothing). Padded graph shapes
        bound recompiles; padded nodes/edges provably contribute nothing
        (pose_graph.pad_nodes / pad_edges)."""
        from icp_tpu.slam.pose_graph import pad_edges, pad_nodes

        k = len(self.map.keyframes)
        graph = graph_from_poses(
            [kf.pose.q for kf in self.map.keyframes],
            [kf.pose.t for kf in self.map.keyframes],
            self.map.edges, self.map.measurements,
            np.asarray(self.map.weights, np.float32))
        n_pad = 1 << max(1, (k - 1).bit_length())
        graph = pad_edges(pad_nodes(graph, n_pad), 64)
        if graph.q.shape[0] > 512:
            from icp_tpu.slam.pose_graph import optimize_pcg

            out = jax.block_until_ready(optimize_pcg(
                graph, iterations=self.incremental_iterations))
        else:
            out = jax.block_until_ready(optimize(
                graph, iterations=self.incremental_iterations))
        self._apply_refined(out.q[:k], out.t[:k])
        self.n_incremental_updates += 1
