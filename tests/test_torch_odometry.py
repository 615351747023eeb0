"""PyTorch port, odometry: keypoint lifts, the rigid fit, RANSAC and the
tracking core against their JAX twins. RANSAC's hypotheses are drawn by
``jax.random`` in the reference; the port draws the same indices on the
device (``rigid.hypothesis_indices``, held bit-equal in
test_torch_step_graph.py), and these tests hand both sides the same
indices so that each fit is compared alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.config import FeatureConfig, MatchConfig, OdometryConfig, StereoConfig
from online_3d_reconstruction_tpu.geometry import se3 as jse3
from online_3d_reconstruction_tpu.io.calibration import identity_rig
from online_3d_reconstruction_tpu.io.synthetic import Plateau, SyntheticScene, nadir_pose
from online_3d_reconstruction_tpu.odometry import frontend as jfront
from online_3d_reconstruction_tpu.odometry import rigid as jrigid
from online_3d_reconstruction_tpu.stereo.sgm import sgm_disparity
from online_3d_reconstruction_tpu_torch.features.brief import Keypoints
from online_3d_reconstruction_tpu_torch.odometry import frontend, rigid
from tests.test_torch_shared import port

torch.set_num_threads(2)

# transforms: both sides run the same f32 fits (3x3 SVD, 6x6 solve) with
# sums in another order; 1e-4 bounds that drift on metre-scale poses
T_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def correspondences():
    rng = np.random.default_rng(4)
    n = 256
    src = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    src[:, 2] += 25.0
    t_true = np.asarray(jse3.exp(
        jnp.asarray([0.8, -0.3, 0.1, 0.01, -0.02, 0.03], jnp.float32)))
    dst = src @ t_true[:3, :3].T + t_true[:3, 3] + rng.normal(0, 0.05, (n, 3))
    outliers = rng.random(n) < 0.3
    dst[outliers] += rng.normal(0, 3.0, (outliers.sum(), 3))
    valid = rng.random(n) < 0.8
    return src, dst.astype(np.float32), valid, t_true


def test_rigid_transform_matches_jax(correspondences):
    """Compare the fitted transforms, not U/V: SVD sign choices differ
    between backends while the reflection-fixed rotation does not."""
    src, dst, valid, _ = correspondences
    w = valid.astype(np.float32)
    want = np.asarray(jrigid.rigid_transform(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    got = rigid.rigid_transform(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=T_ATOL)


def test_ransac_with_injected_samples_matches_jax(correspondences):
    src, dst, valid, t_true = correspondences
    n, iters = src.shape[0], 128
    key = jax.random.PRNGKey(3)
    samples = np.asarray(jax.random.randint(key, (iters, 3), 0, n)).astype(np.int64)
    rot_prior = t_true[:3, :3]
    kw = dict(threshold=0.25, min_inliers=12, rot_prior_weight=5000.0,
              depth_rel_weight=0.2)
    t_j, m_j, c_j, ok_j = jrigid.ransac_rigid(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key, iters=iters,
        rot_prior=jnp.asarray(rot_prior), **kw)
    t_p, m_p, c_p, ok_p = rigid.ransac_rigid(
        _t(src), _t(dst), _t(valid), _t(samples), rot_prior=_t(rot_prior), **kw)
    assert bool(ok_j) and bool(ok_p)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), atol=T_ATOL)
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
    assert int(c_p) == int(c_j)
    np.testing.assert_allclose(t_p.numpy(), t_true, atol=0.05)


def test_hypothesis_indices_seeded_per_frame():
    """The draw of frame 5 from the header's index tensor: the reference's
    own (fold_in of the frame into PRNGKey(0)), the same again, and not
    frame 6's; an int index gives the same draw."""
    a = rigid.hypothesis_indices(0, torch.tensor(5), 128, 256)
    assert a.shape == (128, 3) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 256
    want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(0), 5), (128, 3), 0, 256)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    assert torch.equal(a, rigid.hypothesis_indices(0, 5, 128, 256, "cpu"))
    assert not torch.equal(a, rigid.hypothesis_indices(0, torch.tensor(6), 128, 256))


def _port_features(jf):
    kp = jf.keypoints
    return frontend.FrameFeatures(
        keypoints=Keypoints(xy=_t(kp.xy), score=_t(kp.score), angle=_t(kp.angle),
                            descriptors=_t(np.asarray(kp.descriptors).astype(np.int64)),
                            valid=_t(kp.valid), octave=_t(np.asarray(kp.octave).astype(np.int64))),
        points3d=_t(jf.points3d), valid3d=_t(jf.valid3d))


def test_two_frame_tracking_matches_jax():
    """Features lifted from the same disparity: 3D points within 1e-4 m
    (box-average and Q product summed in another order), validity equal;
    then the tracking core on identical features with the reference's
    samples: relative pose within 1e-4, gate, inlier count and the exported
    (RANSAC-gated) match validity equal."""
    rig = identity_rig(fx=300.0, fy=300.0, cx=128.0, cy=96.0, baseline=0.5,
                       width=256, height=192)
    scene = SyntheticScene(seed=11, plateaus=[Plateau(-3.0, 3.0, -2.0, 4.0, 4.0)])
    stereo = StereoConfig(height=192, width=256, max_disparity=32, num_paths=4,
                          use_pallas=False)
    feat_cfg = FeatureConfig(max_keypoints=256, fast_threshold=5.0)
    odo_cfg = OdometryConfig(ransac_threshold=0.5, min_inliers=10, max_point_depth=40.0)
    match_cfg = MatchConfig(ratio=0.9, max_hamming=80)
    q = np.asarray(rig.q, dtype=np.float32)
    poses = [nadir_pose(0.0, 0.0, 12.0), nadir_pose(0.8, 0.15, 12.0, yaw=0.02)]
    feats_j = []
    for pose in poses:
        f = scene.render_stereo(pose, rig)
        disp, _ = sgm_disparity(jnp.asarray(f.left), jnp.asarray(f.right), stereo)
        fj = jfront.extract_frame_features(jnp.asarray(f.left), disp, jnp.asarray(q),
                                           feat_cfg, odo_cfg)
        kp = fj.keypoints
        pts, ok = frontend.lift_keypoints_to_3d(
            _t(kp.xy), _t(disp), _t(q), max_depth=odo_cfg.max_point_depth,
            edge_threshold=odo_cfg.depth_edge_threshold,
            smooth_radius=odo_cfg.disparity_smooth_radius)
        np.testing.assert_array_equal(ok.numpy() & np.asarray(kp.valid), np.asarray(fj.valid3d))
        np.testing.assert_allclose(pts.numpy(), np.asarray(fj.points3d), atol=1e-4)
        feats_j.append(fj)

    prior_rel = np.eye(4, dtype=np.float32)
    n = feat_cfg.max_keypoints
    key = jax.random.PRNGKey(0)
    rel_j, used_j, count_j, m_j = jfront.odometry_step(
        feats_j[1], feats_j[0], jnp.asarray(prior_rel), key, match_cfg, odo_cfg)
    samples = np.asarray(jax.random.randint(key, (odo_cfg.ransac_iters, 3), 0, n))
    rel_p, used_p, count_p, m_p = frontend.odometry_step(
        _port_features(feats_j[1]), _port_features(feats_j[0]), _t(prior_rel),
        _t(samples.astype(np.int64)), port(match_cfg), port(odo_cfg))
    assert bool(used_j) and bool(used_p)
    np.testing.assert_allclose(rel_p.numpy(), np.asarray(rel_j), atol=T_ATOL)
    assert int(count_p) == int(count_j)
    np.testing.assert_array_equal(m_p.index.numpy(), np.asarray(m_j.index))
    np.testing.assert_array_equal(m_p.valid.numpy(), np.asarray(m_j.valid))
    # the world pose from the keyframe's pose and the relative transform
    kf_pose = np.asarray(jse3.exp(jnp.asarray([2.0, -1.0, 12.0, 0.02, 3.1, -0.03],
                                               jnp.float32)))
    np.testing.assert_allclose(
        frontend.compose_world_pose(_t(kf_pose), rel_p).numpy(),
        np.asarray(jfront.compose_world_pose(jnp.asarray(kf_pose), rel_j)), atol=T_ATOL)
