"""Configuration for the ICP engine.

The reference selects algorithm variants with compile-time template enums
(``ICPStepConfigT{EIGEN, POWER_METHOD}`` x ``ICPStepConfigW{REGULAR,
WEIGHTED}``, reference include/ICP/algorithms.hpp:1544-1564) and passes
runtime knobs through ``init()`` (m, n_r, alpha, c, max_iterations,
angle/translation thresholds, reference include/ICP/algorithms.hpp:2440-2458).

Here the same split becomes: a hashable frozen dataclass ``ICPConfig`` whose
fields are jit-static (they select traced code paths and shapes), and an
``ICPParams`` pytree of dynamic scalars that can change without recompiling.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class


class RotationMode(enum.Enum):
    """Rotation-solve variant (reference ``ICPStepConfigT``).

    SVD mirrors the reference's EIGEN mode (JacobiSVD on the host,
    reference src/ICP/algorithms.cpp:3474-3487) but runs on-device via a
    jit-compatible 3x3 SVD. POWER mirrors the on-device power-method kernel
    (reference kernels/icp_kernels.cl:976-1054). JACOBI completes the
    reference's declared-but-unimplemented third variant
    (``ICPStepConfigT::JACOBI (todo)``, include/ICP/algorithms.hpp:1544-
    1564): a full symmetric eigensolve of Horn's 4x4 N matrix, taking the
    most-positive eigenvalue's eigenvector.
    """

    SVD = "svd"
    POWER = "power"
    JACOBI = "jacobi"


class Weighting(enum.Enum):
    """Residual weighting variant (reference ``ICPStepConfigW``)."""

    REGULAR = "regular"
    WEIGHTED = "weighted"


class Objective(enum.Enum):
    """Error metric of the alignment solve.

    POINT is the reference's objective (Horn absolute orientation on matched
    pairs). PLANE is a beyond-reference extension: point-to-plane
    Gauss-Newton against fixed-surface normals, which removes the
    tangential discretization bias of matching a sampled surface (sub-mm
    where POINT floors at a few mm on the landmark grid). PLANE implies
    rigid (s_k = 1); normals come from the organized grid or from kNN PCA
    on unorganized clouds (``normal_mode``).
    """

    POINT = "point"
    PLANE = "plane"
    # Generalized-ICP (Segal et al., RSS 2009): plane-to-plane. Each point
    # carries a disk covariance C = I - (1 - eps) n n^T (thin along its
    # surface normal); pairs are weighted by the 3x3 Mahalanobis matrix
    # (C_f + R C_m R^T)^{-1}. Degrades gracefully: zero normals give C = I
    # (isotropic, point-to-point behavior), so unorganized clouds still
    # work. Like PLANE this implies rigid (s_k = 1).
    GICP = "gicp"


class RobustKernel(enum.Enum):
    """Robust M-estimator applied to correspondence residuals (IRLS weights).

    Beyond-reference extension: the reference's only robustness device is the
    fixed-scale Cauchy-like weighting ``w = 100/(100+d^2)``
    (kernels/icp_kernels.cl:138-180). A robust kernel composes
    MULTIPLICATIVELY with that weighting (and with REGULAR, which has none),
    gating gross outliers — occlusions, sensor dropouts, dynamic objects —
    out of the Horn / Gauss-Newton solves. The IRLS factor is a function of
    the blended squared NN distance d^2 (geometric mm^2 + alpha-scaled
    photometric) against the scale ``ICPParams.robust_delta`` (same units as
    the blended DISTANCE, i.e. ~mm):

      NONE     1
      HUBER    min(1, delta / d)              (linear tail)
      TUKEY    (1 - d^2/delta^2)^2, 0 beyond  (hard redescending)
      TRIMMED  1 if d <= delta else 0         (max-correspondence-distance
                                               rejection / truncated LS)

    All three are elementwise on d^2 and fuse into the moment tail.
    """

    NONE = "none"
    HUBER = "huber"
    TUKEY = "tukey"
    TRIMMED = "trimmed"


class Correspondence(enum.Enum):
    """Nearest-neighbor search strategy.

    BRUTE computes the full (m x n) distance matrix (exact NN).
    RBC mirrors the reference's Random-Ball-Cover search: nearest
    representative, then exhaustive search within that representative's bin
    (reference external RandomBallCover dep, SURVEY.md §2.5).
    """

    BRUTE = "brute"
    RBC = "rbc"


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static (jit-time) configuration.

    Attributes:
      m: number of landmarks in each set (reference hard-codes 16384).
      n_r: number of representatives (must split into a 2^k x 2^k-ish grid
        for the sampler; reference requires a multiple of 4,
        src/ICP/algorithms.cpp:852-854).
      rotation: rotation solver variant.
      weighting: residual weighting variant.
      robust: robust M-estimator gating outlier correspondences (see
        :class:`RobustKernel`); composes with ``weighting``. Scale knob:
        ``ICPParams.robust_delta``.
      robust_adaptive: derive the robust scale per iteration from the
        masked median residual instead of ``robust_delta`` (MAD-style,
        per-kernel multiples — ops.moments.adaptive_robust_delta). The
        median needs per-pair residuals, which the fused pipelines get from
        an extra distance-only search pass. On the sharded path the median
        is computed by a 3-collective distributed quantile
        (ops.moments.masked_median_sharded: local-median interval
        bracketing + one histogram psum).
      correspondence: NN search strategy.
      max_iterations: iteration cap of the registration loop (reference
        default 40, include/ICP/algorithms.hpp:2440).
      bin_capacity: static per-representative database-bin capacity for the
        RBC structure. Mean occupancy is m / n_r; the default 2x mean
        (rounded up to a multiple of 128) makes overflow vanishingly rare
        on scan data.
        Overflowing database points are dropped from their bin (masked),
        mirroring the fixed-capacity idiom static shapes require.
      query_capacity: static per-bin query capacity for the grouped RBC
        search. Queries overflowing their bin fall back to their nearest
        representative (a real database point) as the match. The default
        1.5x mean occupancy drops ~1% of queries on the worst measured
        scene (zero on the wall scene) with registration accuracy
        unchanged, and the search cost scales ~linearly with this
        capacity; raise it for heavily skewed scenes.
      estimate_scale: solve for Horn's symmetric scale s_k (the reference
        always does). Disable for rigid odometry: on frustum-sampled
        near-planar scenes the (s, t_z) pair is degenerate — a uniform
        scale about the camera center exactly mimics forward translation.
      double_precision_sums: accumulate weight sums in float64 like the
        reference's ``reduce_sum_fd`` promotion (only honored where the
        backend supports f64 and x64 is enabled; f32 otherwise).
    """

    m: int = 16384
    n_r: int = 256
    rotation: RotationMode = RotationMode.POWER
    weighting: Weighting = Weighting.WEIGHTED
    robust: RobustKernel = RobustKernel.NONE
    robust_adaptive: bool = False
    correspondence: Correspondence = Correspondence.RBC
    max_iterations: int = 40
    bin_capacity: int = 0  # 0 -> auto: 2x mean occupancy, 128-multiple
    query_capacity: int = 0  # 0 -> auto: 1.5x mean occupancy, 8-aligned
    estimate_scale: bool = True
    objective: Objective = Objective.POINT
    # PLANE refinement: use the symmetric (averaged fixed+moving) normal
    # per pair — Rusinkiewicz-style symmetric objective, second-order
    # convergence on smooth surfaces. Only meaningful with PLANE.
    plane_symmetric: bool = False
    # Normal estimation for the normal-consuming objectives (PLANE/GICP):
    # "auto" (square counts assumed organized -> grid normals, else zeros),
    # "grid" (organized row-major grid, error if not square), or "knn"
    # (PCA of geometric k-NN — REQUIRED for unorganized clouds such as
    # LiDAR sweeps; auto cannot detect organization). ops.normals.
    normal_mode: str = "auto"
    # Fused POINT pipeline (rbc/fused_point.py): transform + rep assignment
    # + per-bin search + weighting + the whole statistical tail reduce to
    # per-bin 8x8 moment matrices. The default hot path; disable to fall
    # back to the grouped-search + per-pair reduction pipeline (same
    # semantics, more device-memory traffic — useful for A/B).
    fused_point: bool = True
    # Fused PLANE/GICP pipeline (rbc/fused_gn.py): the same structure as
    # fused_point, with per-bin search + weighting + the ENTIRE
    # Gauss-Newton system build reduced to (n_r, 8, 8) moment matrices
    # (GICP's 3x3 Mahalanobis weight splits into two plane-style rows plus
    # an isotropic block — see the module docstring). Ignored for
    # POINT/BRUTE.
    fused_gn: bool = True

    def __post_init__(self):
        if self.m <= 0:
            raise ValueError("The sets of landmarks cannot have zero points")
        if self.n_r <= 0:
            raise ValueError("The sets of representatives cannot have zero points")
        if self.n_r % 4 != 0:
            raise ValueError("n_r must be a multiple of 4")  # ref cpp:845-854
        if self.normal_mode not in ("auto", "grid", "knn", "knn_rbc"):
            raise ValueError(f"normal_mode must be auto|grid|knn|knn_rbc, "
                             f"got {self.normal_mode!r}")
        # Default bin capacity: 2x mean occupancy, rounded up to a multiple
        # of 128 (whole candidate tiles for the per-bin search). Overflow
        # drops database points from their bin (masked).
        mean_occ = max(self.m // self.n_r, 4)
        if self.bin_capacity == 0:
            object.__setattr__(self, "bin_capacity",
                               max(((2 * mean_occ + 127) // 128) * 128, 16))
        # Default query capacity: 1.5x mean occupancy, 8-aligned (whole
        # query tiles for the per-bin search). Search cost is ~linear in
        # this capacity; at 1.5x the overflow fallback hits ~1% of queries
        # on the worst measured scene with registration accuracy unchanged
        # (see the class docstring).
        if self.query_capacity == 0:
            object.__setattr__(self, "query_capacity",
                               max(((3 * mean_occ // 2 + 7) // 8) * 8, 16))

    @property
    def needs_normals(self) -> bool:
        """True when the objective consumes fixed-surface normals (PLANE
        point-to-plane; GICP plane-to-plane covariances)."""
        return self.objective in (Objective.PLANE, Objective.GICP)

    @property
    def needs_index(self) -> bool:
        """True when the pipeline must build an RBCIndex: RBC correspondence
        always; the normal-consuming objectives too (the index carries the
        normals)."""
        return (self.correspondence is Correspondence.RBC
                or self.needs_normals)

    @property
    def rep_grid(self) -> tuple[int, int]:
        """(n_ry, n_rx) split of n_r, mirroring reference cpp:852-854.

        n_r = 2^p -> n_rx = 2^(p - p//2), n_ry = 2^(p//2).
        """
        p = self.n_r.bit_length() - 1
        if (1 << p) != self.n_r:
            raise ValueError("n_r must be a power of 2 for the rep sampler")
        n_ry = 1 << (p // 2)
        n_rx = 1 << (p - p // 2)
        return (n_ry, n_rx)


@register_pytree_node_class
@dataclasses.dataclass
class ICPParams:
    """Dynamic (traced) scalar parameters.

    alpha: photometric blend weight in the 8-D distance
      d^2 = ||x_g - x'_g||^2 + alpha * ||x_p - x'_p||^2
      (reference ``euclideanSquaredMetric8``; library default 1e2, apps use
      2e2 — include/ICP/algorithms.hpp:1654-1655, src/ocl_icp_sbs.cpp:88).
    c: float-safety scaling of deviations before the S-matrix products
      (reference kernels/icp_kernels.cl:609-613; default 1e-6).
    angle_threshold_deg: convergence threshold on the incremental rotation
      angle, degrees (reference default 0.001).
    translation_threshold: convergence threshold on ||t_k||, in the cloud's
      length unit (mm for Kinect data; reference default 0.01).
    gicp_epsilon: GICP disk-covariance thickness along the normal
      (Segal et al. use 1e-3); only read by Objective.GICP.
    robust_delta: scale of the robust kernel (ICPConfig.robust), in blended
      DISTANCE units — mm for pure geometry (the photometric term adds
      alpha-scaled color offsets). Default 100 ~ "reject/damp pairs beyond
      ~10 cm" on Kinect-scale scenes. Only read when robust != NONE.
    """

    alpha: Any = 1e2
    c: Any = 1e-6
    angle_threshold_deg: Any = 0.001
    translation_threshold: Any = 0.01
    gicp_epsilon: Any = 1e-3
    robust_delta: Any = 100.0

    def tree_flatten(self):
        children = (
            self.alpha,
            self.c,
            self.angle_threshold_deg,
            self.translation_threshold,
            self.gicp_epsilon,
            self.robust_delta,
        )
        return children, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def as_f32(self) -> "ICPParams":
        return ICPParams(
            alpha=jnp.float32(self.alpha),
            c=jnp.float32(self.c),
            angle_threshold_deg=jnp.float32(self.angle_threshold_deg),
            translation_threshold=jnp.float32(self.translation_threshold),
            gicp_epsilon=jnp.float32(self.gicp_epsilon),
            robust_delta=jnp.float32(self.robust_delta),
        )
