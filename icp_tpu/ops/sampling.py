"""Landmark and representative samplers.

Pure strided gathers — the reference implements these as tiny device kernels
(``getLMs``, ``getReps``; kernels/icp_kernels.cl:62-114) because its data
lives in OpenCL buffers; under XLA they are static gathers that fuse into
whatever consumes them.
"""

from __future__ import annotations

import jax.numpy as jnp

# Kinect VGA geometry hard-coded throughout the reference
# (kernels/icp_kernels.cl:41-57).
IMAGE_WIDTH = 640
IMAGE_HEIGHT = 480
LM_GRID = 128  # landmarks form a 128 x 128 grid -> 16384 points


def get_landmarks(cloud8: jnp.ndarray) -> jnp.ndarray:
    """Sample a 640x480 cloud for the 128x128 landmark grid.

    Mirrors ``getLMs`` (reference kernels/icp_kernels.cl:62-76): from the
    center 512x384 region, stride 4 in x (offset 1) and 3 in y (offset 1):

        landmark[r, l] = cloud[48 + 3r + 1, 64 + 4l + 1]

    Invalid (all-zero) points pass through; downstream weighting handles
    them, as in the reference.

    Args:
      cloud8: (480, 640, 8) or (307200, 8) point cloud.
    Returns:
      (16384, 8) landmarks in row-major 128x128 grid order.
    """
    img = cloud8.reshape(IMAGE_HEIGHT, IMAGE_WIDTH, 8)

    # Static STRIDED SLICE, not an advanced-index gather — the index-array
    # form lowers as a general 16k-row gather.
    lms = img[49:49 + 3 * LM_GRID:3, 65:65 + 4 * LM_GRID:4]
    return lms.reshape(LM_GRID * LM_GRID, 8)


def get_representatives(landmarks8: jnp.ndarray, n_ry: int, n_rx: int) -> jnp.ndarray:
    """Sample the 128x128 landmark grid for representatives.

    Mirrors ``getReps`` (reference kernels/icp_kernels.cl:96-114): stride
    128/n_r per axis with a centered offset (step/2 - 1):

        rep[ry, rx] = lms[ry * stepY + stepY/2 - 1, rx * stepX + stepX/2 - 1]

    Args:
      landmarks8: (16384, 8) landmarks in 128x128 row-major order.
      n_ry, n_rx: representative grid (see ``ICPConfig.rep_grid``; for
        n_r = 256 this is 16 x 16, per reference cpp:852-854).
    Returns:
      (n_ry * n_rx, 8) representatives.
    """
    grid = landmarks8.reshape(LM_GRID, LM_GRID, 8)
    step_x = LM_GRID // n_rx
    step_y = LM_GRID // n_ry
    y0 = (step_y // 2) - 1
    x0 = (step_x // 2) - 1
    # Static strided slice (see get_landmarks): exact same indices as the
    # reference's ys/xs arrays, minus the gather.
    reps = grid[y0:y0 + n_ry * step_y:step_y, x0:x0 + n_rx * step_x:step_x]
    return reps.reshape(n_ry * n_rx, 8)


def sample_representative_indices(n: int, n_r: int,
                                  grid: tuple[int, int] | None = None
                                  ) -> jnp.ndarray:
    """Indices of the sampled representatives within the landmark set.

    Representatives ARE landmarks at statically known positions, so their
    database indices never need a search (used to skip the RBC construct's
    rep->database argmin).

    Any perfect-square n is treated as an organized side x side grid and
    sampled in 2-D (the reference rule generalized): a 1-D stride on an
    organized grid degenerates to a single column whenever the stride is a
    multiple of the row width — every representative on one image column.
    """
    side = int(round(n ** 0.5))
    if side * side == n and side >= 4:
        if n == LM_GRID * LM_GRID and grid is not None:
            n_ry, n_rx = grid
        else:
            p = n_r.bit_length() - 1
            if (1 << p) == n_r:
                n_ry, n_rx = 1 << (p // 2), 1 << (p - p // 2)
            else:
                n_ry = n_rx = 0
        if n_ry and side % n_rx == 0 and side % n_ry == 0:
            step_x = side // n_rx
            step_y = side // n_ry
            ys = jnp.arange(n_ry) * step_y + max(step_y // 2 - 1, 0)
            xs = jnp.arange(n_rx) * step_x + max(step_x // 2 - 1, 0)
            return (ys[:, None] * side + xs[None, :]).reshape(-1).astype(
                jnp.int32)
    step = n // n_r
    return (jnp.arange(n_r) * step + max(step // 2 - 1, 0)).astype(jnp.int32)


def sample_representatives(points8: jnp.ndarray, n_r: int,
                           grid: tuple[int, int] | None = None) -> jnp.ndarray:
    """Representative sampling for an arbitrary-sized landmark set.

    For the canonical 16384-landmark grid this matches
    :func:`get_representatives` (exact reference semantics). For other sizes
    it applies the 1-D analog of the same rule: stride n/n_r with a centered
    offset (step/2 - 1).
    """
    idx = sample_representative_indices(points8.shape[0], n_r, grid)
    return points8[idx]


def representative_landmark_indices(n_ry: int, n_rx: int) -> jnp.ndarray:
    """Landmark-grid flat indices of the sampled representatives.

    Each representative IS a landmark (getReps samples the landmark set), so
    its index in the 16384-landmark array is statically known. Used by the
    RBC search overflow fallback.
    """
    step_x = LM_GRID // n_rx
    step_y = LM_GRID // n_ry
    ys = jnp.arange(n_ry) * step_y + (step_y // 2) - 1
    xs = jnp.arange(n_rx) * step_x + (step_x // 2) - 1
    return (ys[:, None] * LM_GRID + xs[None, :]).reshape(-1).astype(jnp.int32)
