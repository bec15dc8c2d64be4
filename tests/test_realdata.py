"""Registration on REAL measured data (data/real/README.md): USGS LiDAR
terrain geometry + a real photograph's texture.

The reference validates on captured Kinect pairs (reference
data/README.md) that are absent from the mount; these tests pin the same
contracts on the real data the environment ships:

- registration accuracy on real surface statistics (fault scarps,
  natural roughness — no analytic-renderer regularity) for all three
  objectives, with GICP's plane-to-plane model expected to win;
- the kg_pc8d_wall photometric contract on real image statistics: with
  geometry degenerate (frontal wall), a sufficiently weighted color term
  recovers in-plane motion that geometry alone misses entirely;
- the full TUM pipeline (PNG round-trip, association, odometry,
  ATE/RPE evaluation) on real-geometry imagery.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest


from icp_tpu import ICPConfig, ICPParams, Objective, register
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.ops.sampling import get_landmarks
from icp_tpu.sensors import realdata, synthetic, tum
from icp_tpu.slam import se3

_ID_Q = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
_ZERO_T = np.zeros(3, np.float32)


@pytest.fixture(scope="module")
def terrain():
    return realdata.terrain_surface()


@pytest.fixture(scope="module")
def terrain_pair(terrain):
    """Frames of the real terrain from identity and a known offset pose."""
    pts, rgb = terrain
    th = 0.008
    q_b = np.array([0.0, np.sin(th / 2), 0.0, np.cos(th / 2)], np.float32)
    t_b = np.array([12.0, -7.0, 5.0], np.float32)
    la = get_landmarks(jnp.asarray(
        realdata.observe(pts, rgb, _ID_Q, _ZERO_T).reshape(-1, 8)))
    lb = get_landmarks(jnp.asarray(
        realdata.observe(pts, rgb, q_b, t_b).reshape(-1, 8)))
    rel = se3.relative(
        synthetic.CameraPose.identity(),
        synthetic.CameraPose(jnp.asarray(q_b), jnp.asarray(t_b)))
    return la, lb, rel


def test_observation_model(terrain):
    """Frames of the real surface are full-coverage, Kinect-convention
    clouds; a same-pose re-observation is self-consistent."""
    pts, rgb = terrain
    cloud = realdata.observe(pts, rgb, _ID_Q, _ZERO_T)
    assert cloud.shape == (480, 640, 8)
    valid = cloud[..., 2] > 0
    assert valid.mean() > 0.99
    # Backprojection consistency: x = (u - cx) z / f at every pixel.
    v, u = np.nonzero(valid)
    np.testing.assert_allclose(
        cloud[v, u, 0], (u - 319.5) * cloud[v, u, 2] / 595.0, atol=1e-3)
    # Real relief spans the configured range, real texture is non-trivial.
    z = cloud[..., 2][valid]
    assert z.max() - z.min() > 300.0
    assert cloud[..., 4:7][valid].std() > 0.05


@pytest.mark.parametrize("objective,t_bound,a_bound", [
    (Objective.POINT, 8.0, 0.4),
    (Objective.PLANE, 3.0, 0.12),
    (Objective.GICP, 1.5, 0.05),
])
def test_terrain_registration(terrain_pair, objective, t_bound, a_bound):
    """Known-transform registration on real LiDAR terrain. The bounds are
    the measured floors (resampling noise + real surface roughness) with
    ~2x headroom; GICP's plane-to-plane model is the most robust to the
    roughness, POINT the least — the expected ordering."""
    la, lb, rel = terrain_pair
    st = jax.block_until_ready(register(
        la, lb, ICPParams(alpha=2e2).as_f32(),
        ICPConfig(estimate_scale=False, objective=objective)))
    t_err = float(jnp.linalg.norm(st.t - rel.t))
    a_err = float(qangle_deg(qmul(st.q, qconj(rel.q))))
    assert t_err < t_bound, (t_err, objective)
    assert a_err < a_bound, (a_err, objective)


def test_raw_lidar_unorganized_knn_registration(terrain):
    """RAW LiDAR sweep registration: a random subsample of the real
    terrain points — NO camera projection, NO grid organization — under a
    known rigid transform, with normal_mode="knn" providing the PLANE
    normals the organized-grid estimator cannot. This is the LiDAR
    workflow (scan-to-scan matching on scattered points)."""
    from icp_tpu.icp.quaternion import qrotate, transform_points

    pts, rgb = terrain
    rng = np.random.default_rng(3)
    sel = rng.choice(pts.shape[0], 4096, replace=False)
    fixed = np.ones((4096, 8), np.float32)
    fixed[:, :3] = pts[sel]
    fixed[:, 4:7] = rgb[sel]

    th = 0.01
    q = np.array([0.0, np.sin(th / 2), 0.0, np.cos(th / 2)], np.float32)
    t = np.array([15.0, -9.0, 6.0], np.float32)
    qi = qconj(jnp.asarray(q))
    moving = transform_points(jnp.asarray(fixed), qi,
                              -qrotate(qi, jnp.asarray(t)), jnp.float32(1.0))

    config = ICPConfig(m=4096, n_r=64, objective=Objective.PLANE,
                       normal_mode="knn", estimate_scale=False)
    st = jax.block_until_ready(register(
        jnp.asarray(fixed), moving, ICPParams(alpha=2e2).as_f32(), config))
    t_err = float(jnp.linalg.norm(st.t - jnp.asarray(t)))
    a_err = float(qangle_deg(qmul(st.q, qconj(jnp.asarray(q)))))
    # Exact correspondences exist (same sample set), so the floor is the
    # solver itself; bounds carry ~10x headroom over measured.
    assert t_err < 0.5, t_err
    assert a_err < 0.05, a_err


def test_wall_alpha_contract_real_texture():
    """The kg_pc8d_wall contract on a REAL photograph: frontal wall,
    motion ~2.5x the landmark pitch. Geometry alone (alpha -> 0) misses
    the in-plane motion entirely; the photometric term at matching-scale
    weight (alpha |dc|^2 must beat the |motion|^2 geometric penalty of
    the aliasing match, here alpha ~ 4e5) recovers it to a few mm.
    Wall-normal translation is exact either way (geometry constrains it).
    """
    pts, rgb = realdata.wall_surface()
    t_b = np.array([30.0, -15.0, 4.0], np.float32)
    la = get_landmarks(jnp.asarray(
        realdata.observe(pts, rgb, _ID_Q, _ZERO_T).reshape(-1, 8)))
    lb = get_landmarks(jnp.asarray(
        realdata.observe(pts, rgb, _ID_Q, t_b).reshape(-1, 8)))
    config = ICPConfig(estimate_scale=False, max_iterations=60)

    def run(alpha):
        st = jax.block_until_ready(register(
            la, lb, ICPParams(alpha=alpha).as_f32(), config))
        lat = float(np.linalg.norm(np.asarray(st.t[:2]) - t_b[:2]))
        z_err = abs(float(st.t[2]) - float(t_b[2]))
        return lat, z_err

    lat_photo, z_photo = run(4e5)
    lat_geo, z_geo = run(1e-6)
    assert z_photo < 0.5 and z_geo < 0.5  # normal direction: always exact
    assert lat_photo < 6.0, lat_photo     # color recovers in-plane motion
    assert lat_geo > 25.0, lat_geo        # geometry alone: total miss


def test_tum_pipeline_on_real_terrain(terrain, tmp_path):
    """Full TUM chain on real-geometry imagery: write frames of the real
    terrain in TUM format, read them back through the PNG loader, run
    frame-to-frame odometry, and pin ATE/RPE against the ground truth."""
    pts, rgb = terrain
    poses = []
    for i in range(4):
        t = np.array([10.0 * i, -6.0 * i, 4.0 * i], np.float32)
        poses.append(synthetic.CameraPose(jnp.asarray(_ID_Q),
                                          jnp.asarray(t)))
    def frame_of(p):
        c = realdata.observe(pts, rgb, np.asarray(p.q), np.asarray(p.t))
        return c[..., 2], c[..., 4:7]

    frames = (frame_of(p) for p in poses)
    root = str(tmp_path)
    seq = tum.write_sequence(root, frames, poses)
    assert len(seq) == 4 and seq.gt_t is not None

    # Frame-to-frame odometry through the PNG loader (renderer f=595).
    params = ICPParams(alpha=2e2).as_f32()
    config = ICPConfig(estimate_scale=False, objective=Objective.PLANE)
    est_q, est_t = [np.asarray(_ID_Q)], [np.zeros(3, np.float64)]
    prev = None
    pose = se3.Pose(jnp.asarray(_ID_Q), jnp.zeros(3))
    for cloud in tum.sequence_clouds(seq, fx=595.0, fy=595.0):
        lms = get_landmarks(jnp.asarray(cloud.reshape(-1, 8)))
        if prev is not None:
            st = jax.block_until_ready(register(prev, lms, params, config))
            pose = se3.compose(pose, se3.Pose(st.q, st.t))
            est_q.append(np.asarray(pose.q))
            est_t.append(np.asarray(pose.t))
        prev = lms

    ate, rpe_t, rpe_r = tum.evaluate_trajectory(
        seq, np.stack(est_q), np.stack(est_t))
    # Bounds: per-frame PLANE floor on this data is ~2-3 mm; 3 steps of
    # drift stay within 8 mm ATE / 5 mm RPE (in TUM meters).
    assert ate < 8e-3, ate
    assert rpe_t < 5e-3, rpe_t
    assert rpe_r < 0.2, rpe_r
