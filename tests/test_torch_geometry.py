"""PyTorch port, geometry: SE(3) utilities and disparity backprojection
against their JAX twins on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_3d_reconstruction_tpu.geometry import backproject as jbp
from online_3d_reconstruction_tpu.geometry import se3 as jse3
from online_3d_reconstruction_tpu_torch.geometry import backproject, se3

torch.set_num_threads(2)

# f32 pose math on both sides, but XLA and torch order their sums and
# fuse their multiply-adds differently: agreement to a few f32 ulps of
# the O(1..10) values involved.
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def poses():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.6, size=(5, 6)).astype(np.float32)
    xi[0, 3:] = 1e-6   # small-angle series branch
    return xi, np.asarray(jse3.exp(jnp.asarray(xi)))


def test_exp_log_match_jax(poses):
    xi, t_jax = poses
    t = se3.exp(_t(xi))
    np.testing.assert_allclose(t.numpy(), t_jax, atol=ATOL)
    np.testing.assert_allclose(se3.log(t).numpy(),
                               np.asarray(jse3.log(jnp.asarray(t_jax))), atol=1e-4)
    np.testing.assert_allclose(se3.log(t).numpy(), xi, atol=1e-4)


def test_compose_inverse_transform_match_jax(poses):
    _, t_jax = poses
    a, b = t_jax[1], t_jax[2]
    pts = np.random.default_rng(1).normal(0, 10, size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(se3.compose(_t(a), _t(b)).numpy(),
                               np.asarray(jse3.compose(a, b)), atol=ATOL)
    np.testing.assert_allclose(se3.inverse(_t(t_jax)).numpy(),
                               np.asarray(jse3.inverse(jnp.asarray(t_jax))), atol=ATOL)
    np.testing.assert_allclose(se3.transform_points(_t(a), _t(pts)).numpy(),
                               np.asarray(jse3.transform_points(a, pts)), atol=1e-4)
    rot = t_jax[3, :3, :3]
    np.testing.assert_allclose(se3.from_rt(_t(rot), _t(a[:3, 3])).numpy(),
                               np.asarray(jse3.from_rt(rot, a[:3, 3])), atol=0)
    np.testing.assert_allclose(se3.log_so3(_t(rot)).numpy(),
                               np.asarray(jse3.log_so3(rot)), atol=ATOL)


def test_identity_matches_jax():
    np.testing.assert_array_equal(se3.identity("cpu").numpy(), np.asarray(jse3.identity()))
    assert se3.identity("cpu").dtype == torch.float32


def test_geodesic_distance_matches_jax(poses):
    """Batched and single pairs, rotations up to ~1 rad apart (log_so3 of
    the relative pose, as in the reference)."""
    _, t_jax = poses
    a, b = t_jax[:4], t_jax[1:]
    jt, jr = jse3.geodesic_distance(jnp.asarray(a), jnp.asarray(b))
    tt, tr = se3.geodesic_distance(_t(a), _t(b))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)
    st, sr = se3.geodesic_distance(_t(a[0]), _t(a[0]))
    assert float(st) < 1e-6 and float(sr) < 1e-3


def test_euler_to_rotation_matches_jax():
    """ZYX flight-log attitude, batched; a few f32 ulps (3x3 products)."""
    rng = np.random.default_rng(4)
    rpy = rng.uniform(-np.pi, np.pi, size=(3, 16)).astype(np.float32)
    want = np.asarray(jse3.euler_to_rotation(*map(jnp.asarray, rpy)))
    got = se3.euler_to_rotation(*map(_t, rpy)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), got.shape), atol=1e-5)


def test_quaternion_to_rotation_matches_jax():
    """Unnormalized (w, x, y, z) inputs, normalized first on both sides."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(16, 4)).astype(np.float32) * 3.0
    want = np.asarray(jse3.quaternion_to_rotation(jnp.asarray(q)))
    got = se3.quaternion_to_rotation(_t(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


@pytest.mark.parametrize("prestrided,substride", [(False, 1), (True, 2)])
def test_backproject_matches_jax(stereo_frame, small_rig, prestrided, substride):
    """The pipeline's two color modes: full-resolution color (first frame)
    and color prestrided at twice the point stride (steady frames).
    Points within 1e-5 relative (same Q product, summed in another order),
    masks and colors exact."""
    disp = stereo_frame.gt_disparity
    color = stereo_frame.left_rgb
    if prestrided:
        color = color[::2 * substride, ::2 * substride]
    q = np.asarray(small_rig.q, dtype=np.float32)
    kw = dict(stride=2, min_depth=1.0, max_depth=60.0, invalid_value=-1.0,
              color_prestrided=prestrided, color_substride=substride)
    want = jbp.backproject_disparity(jnp.asarray(disp), jnp.asarray(color),
                                     jnp.asarray(q), **kw)
    got = backproject.backproject_disparity(_t(disp), _t(color), _t(q), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.colors.numpy(), np.asarray(want.colors))
    np.testing.assert_array_equal(
        backproject.q_matrix(200.0, 200.0, 128.0, 96.0, 0.5, device="cpu").numpy(),
        np.asarray(jbp.q_matrix(200.0, 200.0, 128.0, 96.0, 0.5)))


def test_cloud_stats_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 5, (257, 3)).astype(np.float32)
    cols = rng.random((257, 3)).astype(np.float32)
    for valid in (rng.random(257) < 0.7, np.zeros(257, bool)):
        n_j, c_j = jbp.cloud_stats(jbp.PointCloud(jnp.asarray(pts), jnp.asarray(cols),
                                                  jnp.asarray(valid)))
        n_t, c_t = backproject.cloud_stats(backproject.PointCloud(
            torch.from_numpy(pts), torch.from_numpy(cols), torch.from_numpy(valid)))
        assert int(n_t) == int(n_j)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL)
