"""The on-card renderer against the port's numpy renderer, and the
circuits' closure (CPU)."""

import numpy as np
import pytest
import torch

from o3r_bench.scene.circuit import circuit_poses, nadir_pose, prior_pose
from o3r_bench.scene.render import Camera, Scene, render_stereo

from online_3d_reconstruction_tpu_torch.io import (
    CameraIntrinsics,
    Plateau,
    StereoCalibration,
    SyntheticScene,
    stereo_rectify,
)

SURVEY_LEGS = [[0, 0], [66, 0], [66, 7.2], [0, 7.2], [0, 14.4], [66, 14.4],
               [66, 21.6], [0, 21.6]]


@pytest.mark.parametrize("rotated", [False, True])
def test_render_matches_numpy_renderer(rotated):
    """64x48, supersample 2, the distorted rig (and a rotated, unequal
    right camera): float32 rounding apart."""
    torch.set_num_threads(2)
    w, h = 64, 48
    left = CameraIntrinsics(fx=50.0, fy=50.0, cx=w / 2, cy=h / 2, width=w, height=h,
                            dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
    right = left
    rotation = np.eye(3)
    if rotated:
        right = CameraIntrinsics(fx=49.0, fy=48.5, cx=w / 2 + 1.5, cy=h / 2 - 0.5,
                                 width=w, height=h, dist=(-0.28, 0.07, 1e-4, -4e-5, 0.0))
        c, s = np.cos(0.01), np.sin(0.01)
        rotation = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    calib = StereoCalibration(left=left, right=right, rotation=rotation,
                              translation=np.array([-0.5, 0.0, 0.0]))
    rig = stereo_rectify(calib)
    scene_np = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                              supersample=2)
    scene = Scene(seed=5, plateaus=((-6.0, 6.0, -4.0, 8.0, 8.0),), supersample=2)
    poses = np.stack([nadir_pose(0.0, 0.0, 30.0, 0.02), nadir_pose(3.6, 1.0, 30.0, -0.01)])

    def cam(c):
        return Camera(c.fx, c.fy, c.cx, c.cy, c.width, c.height, tuple(c.dist))

    out_l, out_r, out_c = render_stereo(scene, poses, cam(left), cam(right), rig.r1,
                                        calib.rotation, calib.translation, "cpu", batch=1)
    for i, pose in enumerate(poses):
        ref = scene_np.render_stereo(pose, rig, calib=calib)
        for got, want in ((out_l[i], ref.left), (out_r[i], ref.right),
                          (out_c[i], ref.left_rgb)):
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_circuit_closes():
    """The step from the last pose to the first equals every other step."""
    for legs, step, alt in ((SURVEY_LEGS, 1.2, 30.0),
                            ([[0, 0], [3.52, 0], [3.52, 1.6], [0, 1.6]], 0.04, 3.0)):
        poses = circuit_poses(legs, step, 256, alt, yaw_wobble=0.03)
        cycled = np.concatenate([poses, poses[:1]])
        steps = np.linalg.norm(np.diff(cycled[:, :3, 3], axis=0), axis=1)
        assert len(poses) == 256
        np.testing.assert_allclose(steps, step, rtol=0, atol=1e-9)
        np.testing.assert_allclose(poses[:, 2, 3], alt)


def test_circuit_refuses_an_open_loop():
    with pytest.raises(ValueError):
        circuit_poses([[0, 0], [10, 0], [10, 1]], 1.2, 20, 30.0)


def test_priors_depend_on_seed_and_index_only():
    gt = nadir_pose(1.0, 2.0, 30.0)
    a = prior_pose(gt, 12345678901, 7, 0.15, 0.01)
    assert np.array_equal(a, prior_pose(gt, 12345678901, 7, 0.15, 0.01))
    assert not np.array_equal(a, prior_pose(gt, 12345678901, 8, 0.15, 0.01))
    assert not np.array_equal(a, prior_pose(gt, 12345678902, 7, 0.15, 0.01))
    assert a.dtype == np.float32
