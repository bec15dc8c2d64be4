"""Guided image filter for RGB and depth denoising.

The reference's frame grabber optionally denoises through its GuidedFilter
dependency (``GuidedFilterRGB<SEPARATED>``, ``GuidedFilterDepth``; radius 5,
eps 0.005, depth scaling 1e-3 — reference src/kinect_frame_grabber.cpp:
179-243). This is the He et al. guided filter with the guide equal to the
input (self-guided edge-preserving smoothing).

The box filter is two cumulative sums + shifted differences
(integral-image form) — O(HW) independent of radius, all fused by XLA.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

DEFAULT_RADIUS = 5
DEFAULT_EPS = 0.005
DEPTH_SCALE = 1e-3  # reference scales depth (mm) to meters before filtering


def _box_1d(x: jnp.ndarray, r: int, axis: int) -> jnp.ndarray:
    """Box sum of width 2r+1 along an axis via cumsum differences, with
    edge-clamped windows (windows are cropped at the borders)."""
    n = x.shape[axis]
    c = jnp.cumsum(x, axis=axis)
    zero = jnp.zeros_like(jnp.take(c, jnp.array([0]), axis=axis))
    c = jnp.concatenate([zero, c], axis=axis)  # c[i] = sum x[:i]
    hi = jnp.clip(jnp.arange(n) + r + 1, 0, n)
    lo = jnp.clip(jnp.arange(n) - r, 0, n)
    return jnp.take(c, hi, axis=axis) - jnp.take(c, lo, axis=axis)


def box_filter(x: jnp.ndarray, r: int) -> jnp.ndarray:
    """Mean filter over (2r+1)^2 windows (cropped at borders) on (H, W)."""
    s = _box_1d(_box_1d(x, r, 0), r, 1)
    ones = jnp.ones_like(x)
    area = _box_1d(_box_1d(ones, r, 0), r, 1)
    return s / area


def guided_filter(guide: jnp.ndarray, src: jnp.ndarray,
                  radius: int = DEFAULT_RADIUS,
                  eps: float = DEFAULT_EPS,
                  mask: jnp.ndarray = None) -> jnp.ndarray:
    """Gray guided filter q = mean(a) * I + mean(b) (He et al. 2010).

    Args:
      guide: (H, W) guide image I.
      src: (H, W) input p to be filtered.
      mask: optional (H, W) validity — statistics become normalized
        convolutions over valid pixels only (invalid pixels otherwise enter
        the window means as literal zeros and bias every valid neighbor,
        e.g. a ~2 mm pull around each depth hole at 2 m range).
    """
    if mask is None:
        mean = lambda x: box_filter(x, radius)
    else:
        v = mask.astype(guide.dtype)
        denom = jnp.maximum(box_filter(v, radius), 1e-12)

        def mean(x):
            return box_filter(x * v, radius) / denom

    mean_i = mean(guide)
    mean_p = mean(src)
    corr_ip = mean(guide * src)
    corr_ii = mean(guide * guide)
    var_i = corr_ii - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return mean(a) * guide + mean(b)


@partial(jax.jit, static_argnames=("radius",))
def filter_rgb(rgb: jnp.ndarray, radius: int = DEFAULT_RADIUS,
               eps: float = DEFAULT_EPS) -> jnp.ndarray:
    """Per-channel self-guided filtering of an (H, W, 3) image in [0, 1] —
    the reference's SEPARATED RGB configuration."""
    chans = [guided_filter(rgb[..., c], rgb[..., c], radius, eps)
             for c in range(3)]
    return jnp.clip(jnp.stack(chans, axis=-1), 0.0, 1.0)


@partial(jax.jit, static_argnames=("radius",))
def filter_depth(depth_mm: jnp.ndarray, radius: int = DEFAULT_RADIUS,
                 eps: float = DEFAULT_EPS) -> jnp.ndarray:
    """Self-guided filtering of an (H, W) depth map in mm.

    Depth is scaled to meters first (reference depth scaling 1e-3) so eps is
    commensurate; invalid (zero) pixels stay invalid AND are excluded from
    the window statistics (normalized convolution)."""
    d = depth_mm * DEPTH_SCALE
    valid = depth_mm > 0
    out = guided_filter(d, d, radius, eps, mask=valid) / DEPTH_SCALE
    return jnp.where(valid, out, 0.0)
