"""Synthetic Kinect-like RGB-D renderer.

The reference ships captured `.bin` clouds (absent from the mount —
SURVEY.md §6) and a libfreenect grabber. This module replaces both: an
analytic ray-traced scene (textured back wall + spheres +
floor) rendered through the reference's pinhole model from arbitrary SE(3)
camera poses, so frame pairs and whole trajectories come with exact
ground-truth transforms. Fully jittable; one `vmap`-free vectorized pass
renders all 640x480 rays at once.

Units match the reference: millimeters, camera looking down +z.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from icp_tpu.icp.quaternion import qidentity, qrotate
from icp_tpu.sensors.pinhole import CX, CY, FOCAL, HEIGHT, WIDTH, backproject


class CameraPose(NamedTuple):
    """World-from-camera pose: p_world = R(q) p_cam + t."""

    q: jnp.ndarray  # (4,) [x, y, z, w]
    t: jnp.ndarray  # (3,) mm

    @staticmethod
    def identity():
        return CameraPose(qidentity(), jnp.zeros((3,), jnp.float32))


class Scene(NamedTuple):
    """Analytic scene: one back wall plane, one floor plane, K spheres.

    planes: (2, 4) rows [nx, ny, nz, d] with n.p = d.
    spheres: (K, 4) rows [cx, cy, cz, radius].
    """

    planes: jnp.ndarray
    spheres: jnp.ndarray


def default_scene(n_spheres: int = 5) -> Scene:
    """Corner room + large close spheres: enough 3-D structure that
    point-to-point ICP is fully constrained (frontal flat-wall-only scenes
    leave a lateral sliding mode that only photometry weakly pins — the
    regime the reference's kg_pc8d_wall dataset stresses; use
    :func:`wall_scene` for that)."""
    planes = jnp.array(
        [
            [0.0, 0.0, -1.0, -2400.0],  # back wall at z = 2400
            [-1.0, 0.0, 0.0, -900.0],  # side wall at x = -900
            [0.0, -1.0, 0.0, -700.0],  # floor at y = 700
        ],
        jnp.float32,
    )
    spheres = jnp.array(
        [
            [-350.0, 120.0, 1500.0, 260.0],
            [300.0, -180.0, 1300.0, 220.0],
            [0.0, 260.0, 1700.0, 280.0],
            [-120.0, -260.0, 1100.0, 180.0],
            [520.0, 160.0, 1800.0, 260.0],
        ],
        jnp.float32,
    )[:n_spheres]
    return Scene(planes, spheres)


def wall_scene() -> Scene:
    """A single textured frontal wall — the photometric-term stress case
    (geometric registration is degenerate in-plane; cf. the reference's
    kg_pc8d_wall dataset, data/README.md)."""
    return Scene(
        planes=jnp.array([[0.0, 0.0, -1.0, -2000.0]], jnp.float32),
        spheres=jnp.zeros((0, 4), jnp.float32),
    )


def _texture(p: jnp.ndarray) -> jnp.ndarray:
    """Procedural RGB texture on world coordinates (..., 3) -> (..., 3).

    Continuous multi-frequency gradients: the photometric term can only pin
    translation on flat geometry if color varies smoothly at fine scale
    (piecewise-constant textures like a checker have zero gradient inside
    cells and let photogeometric ICP slide — the regime the reference's
    kg_pc8d_wall dataset exercises, data/README.md)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    # Wavelengths (2*pi*scale ~ 400-1500 mm) sit several octaves above the
    # landmark sampling pitch on distant surfaces (~15-20 mm at 2.2 m): the
    # sampled color field must be band-limited or NN photometric matching
    # sees aliased noise instead of a gradient.
    r = 0.5 + 0.25 * jnp.sin(x / 70.0) + 0.2 * jnp.sin(y / 110.0) \
        + 0.1 * jnp.sin((x - y) / 230.0)
    g = 0.5 + 0.25 * jnp.cos(y / 90.0) + 0.2 * jnp.cos(x / 140.0) \
        + 0.1 * jnp.cos((x + y) / 260.0)
    b = 0.5 + 0.25 * jnp.sin((x + y) / 120.0) + 0.2 * jnp.cos(z / 160.0)
    return jnp.clip(jnp.stack([r, g, b], -1), 0.0, 1.0)


@jax.jit
def render(scene: Scene, pose: CameraPose):
    """Ray-trace the scene -> (depth (H, W) mm, rgb (H, W, 3)).

    Rays through pixel (u, v): direction D_cam = [(u-cx)/f, (v-cy)/f, 1];
    the camera-frame hit depth is exactly the ray parameter s because
    D_cam.z = 1 — matching the reference's z = d convention.
    """
    u = jnp.arange(WIDTH, dtype=jnp.float32)[None, :]
    v = jnp.arange(HEIGHT, dtype=jnp.float32)[:, None]
    d_cam = jnp.stack(
        [
            jnp.broadcast_to((u - CX) / FOCAL, (HEIGHT, WIDTH)),
            jnp.broadcast_to((v - CY) / FOCAL, (HEIGHT, WIDTH)),
            jnp.ones((HEIGHT, WIDTH), jnp.float32),
        ],
        axis=-1,
    )  # (H, W, 3)
    D = qrotate(pose.q, d_cam)  # world-frame direction
    o = pose.t  # world-frame origin

    big = jnp.float32(1e10)

    # Planes: s = (d - n.o) / (n.D)
    n = scene.planes[:, :3]  # (P, 3)
    d = scene.planes[:, 3]  # (P,)
    denom = jnp.einsum("pk,hwk->hwp", n, D,
                       precision=jax.lax.Precision.HIGHEST)
    s_pl = (d - n @ o)[None, None, :] / jnp.where(jnp.abs(denom) > 1e-8, denom, 1e-8)
    s_pl = jnp.where((s_pl > 1.0) & (jnp.abs(denom) > 1e-8), s_pl, big)

    # Spheres: |o + sD - c|^2 = r^2.
    c = scene.spheres[:, :3]  # (K, 3)
    r = scene.spheres[:, 3]
    oc = o - c  # (K, 3)
    A = jnp.sum(D * D, -1)[..., None]  # (H, W, 1)
    B = 2.0 * jnp.einsum("hwk,sk->hws", D, oc,
                         precision=jax.lax.Precision.HIGHEST)
    Cq = jnp.sum(oc * oc, -1)[None, None, :] - r[None, None, :] ** 2
    disc = B * B - 4.0 * A * Cq
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    s_sp = (-B - sqrt_disc) / (2.0 * A)
    s_sp = jnp.where((disc > 0.0) & (s_sp > 1.0), s_sp, big)

    s_all = jnp.concatenate([s_pl, s_sp], axis=-1)  # (H, W, P+K)
    s = jnp.min(s_all, axis=-1)
    hit = s < big

    p_world = o + s[..., None] * D
    rgb = jnp.where(hit[..., None], _texture(p_world), 0.0)
    depth = jnp.where(hit, s, 0.0)  # 0 = invalid, like Kinect
    return depth, rgb


@jax.jit
def render_cloud(scene: Scene, pose: CameraPose) -> jnp.ndarray:
    """Render and back-project to the CAMERA frame -> (H, W, 8) cloud.

    Points are expressed in the camera frame (like real Kinect output), so
    registering frame B to frame A recovers the relative pose A_from_B.
    """
    depth, rgb = render(scene, pose)
    return backproject(depth, rgb)


def orbit_trajectory(n_frames: int, radius_mm: float = 60.0,
                     yaw_rad: float = 0.06) -> list[CameraPose]:
    """A gentle arc of camera poses for odometry-chain tests: per-frame
    translation ~radius/n and yaw ~yaw/n — Kinect-scale inter-frame motion."""
    import numpy as np

    poses = []
    for i in range(n_frames):
        frac = i / max(n_frames - 1, 1)
        ang = yaw_rad * frac
        q = np.array([0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)], np.float32)
        t = np.array(
            [radius_mm * np.sin(2 * np.pi * frac) * 0.5,
             10.0 * np.sin(4 * np.pi * frac),
             radius_mm * frac],
            np.float32,
        )
        poses.append(CameraPose(jnp.asarray(q), jnp.asarray(t)))
    return poses


def wavy_surface_pair(m: int, seed_a: int = 1, seed_b: int = 2,
                      ang_rad: float = 0.004,
                      t_mm: tuple = (10.0, -6.0, 8.0)):
    """Ground-truth registration pair at arbitrary m (scaled-shape gates).

    Two INDEPENDENT random samplings of an analytic wavy surface (each
    cloud its own sample lattice, so correspondences are approximate — a
    real registration problem, unlike a point-for-point transformed copy)
    plus a known rigid transform applied to the second. Returns numpy
    ``(fixed, moving, q_gt, t_gt)`` with moving in the moving frame
    (p_m = R^T (p_w - t)), so ``register(fixed, moving)`` should recover
    ``(q_gt, t_gt)`` — the convention of the reference's frame-grabber
    pairs (data/README.md) and of bench.py's rendered gates.
    """
    import numpy as np

    def sample(seed):
        rng = np.random.default_rng(seed)
        u = rng.uniform(-400, 400, m).astype(np.float32)
        v = rng.uniform(-300, 300, m).astype(np.float32)
        z = 1500 + 80 * np.sin(u / 90) + 60 * np.cos(v / 70)
        cloud = np.ones((m, 8), np.float32)
        cloud[:, :3] = np.stack([u, v, z], -1)
        cloud[:, 4] = 0.5 + 0.5 * np.sin(u / 40)
        cloud[:, 5] = 0.5 + 0.5 * np.cos(v / 55)
        cloud[:, 6] = np.clip((z - 1350) / 300.0, 0, 1)
        return cloud

    fixed = sample(seed_a)
    world_b = sample(seed_b)
    q = np.array([0, np.sin(ang_rad), 0, np.cos(ang_rad)], np.float32)
    t = np.asarray(t_mm, np.float32)
    R = np.array([
        [1 - 2 * q[1] ** 2, 0, 2 * q[1] * q[3]],
        [0, 1, 0],
        [-2 * q[1] * q[3], 0, 1 - 2 * q[1] ** 2]], np.float32)
    moving = world_b.copy()
    moving[:, :3] = (world_b[:, :3] - t) @ R
    return fixed, moving, q, t
