"""PyTorch port, the one-dispatch steady frame (runtime/step_graph.py) and
the sync-free forms it needs, against their JAX twins and the eager engine:

- the device RANSAC draw bit-equal to ``jax.random`` for the reference's
  key and frame index, and ``tracking_step`` on the reference's frames
  without any indices handed over;
- the rigid fit (Horn's quaternion in place of the SVD), its Gauss-Newton
  polish, ``se3.exp`` / ``log``, and the device-count window over a window
  that fills and slides, each against the reference at the tolerances of
  the existing port tests;
- the static-buffer step (``_step="static"``: the CUDA graph's buffers and
  body, no capture) bit-equal to the eager engine over the 8-frame
  distorted sequence with keyframes and window BA, the host's kept values
  never overwritten by the next frame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.ba import device_tracks as jdt
from online_3d_reconstruction_tpu.config import BAConfig, FeatureConfig, MatchConfig, OdometryConfig, StereoConfig
from online_3d_reconstruction_tpu.geometry import se3 as jse3
from online_3d_reconstruction_tpu.io.calibration import identity_rig
from online_3d_reconstruction_tpu.io.synthetic import Plateau, SyntheticScene, nadir_pose
from online_3d_reconstruction_tpu.odometry import frontend as jfront
from online_3d_reconstruction_tpu.odometry import rigid as jrigid
from online_3d_reconstruction_tpu.stereo.sgm import sgm_disparity
from online_3d_reconstruction_tpu_torch.ba import device_tracks
from online_3d_reconstruction_tpu_torch.geometry import se3
from online_3d_reconstruction_tpu_torch.odometry import frontend, rigid
from online_3d_reconstruction_tpu_torch.runtime import pipeline
from tests.test_device_ba import _chain_scenario
from tests.test_torch_ba import _ring_run
from tests.test_torch_odometry import T_ATOL, _port_features
from tests.test_torch_pipeline import _config, sequence  # noqa: F401
from tests.test_torch_shared import port

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the RANSAC draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 256, 300, 7, 70_000])
@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_hypothesis_indices_bit_equal_to_jax(seed, n):
    """randint(fold_in(PRNGKey(seed), i), (iters, 3), 0, n) for frame
    indices 0, 1, 17 and 2^20, from a 0-dim index tensor as the packed
    header gives it; n a power of two or not, and one above 2^16 (where
    randint's uint32 multiplier wraps to 0)."""
    for frame in (0, 1, 17, 2**20):
        want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), frame),
                                  (128, 3), 0, n)
        got = rigid.hypothesis_indices(seed, torch.tensor(frame), 128, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(frame))


def test_tracking_step_matches_jax_without_injected_samples():
    """Two frames of the identity-rig scene, features from the reference:
    the port's ``tracking_step`` (its own device draw from the frame index
    tensor) against the reference's (its PRNG key and index): world pose
    within 1e-4, the VO gate, inlier count and the exported matches equal."""
    rig = identity_rig(fx=300.0, fy=300.0, cx=128.0, cy=96.0, baseline=0.5,
                       width=256, height=192)
    scene = SyntheticScene(seed=11, plateaus=[Plateau(-3.0, 3.0, -2.0, 4.0, 4.0)])
    stereo = StereoConfig(height=192, width=256, max_disparity=32, num_paths=4,
                          use_pallas=False)
    feat_cfg = FeatureConfig(max_keypoints=256, fast_threshold=5.0)
    odo_cfg = OdometryConfig(ransac_threshold=0.5, min_inliers=10, max_point_depth=40.0,
                             seed=7)
    match_cfg = MatchConfig(ratio=0.9, max_hamming=80)
    q = jnp.asarray(np.asarray(rig.q, dtype=np.float32))
    poses = [nadir_pose(0.0, 0.0, 12.0), nadir_pose(0.8, 0.15, 12.0, yaw=0.02)]
    feats = []
    for pose in poses:
        f = scene.render_stereo(pose, rig)
        disp, _ = sgm_disparity(jnp.asarray(f.left), jnp.asarray(f.right), stereo)
        feats.append(jfront.extract_frame_features(jnp.asarray(f.left), disp, q,
                                                   feat_cfg, odo_cfg))
    kf_pose = np.asarray(jse3.exp(jnp.asarray([2.0, -1.0, 12.0, 0.02, 3.1, -0.03],
                                               jnp.float32)))
    kf_prior = np.asarray(poses[0], np.float32)
    prior = np.asarray(poses[1], np.float32)
    frame = 17
    want = jfront.tracking_step(feats[1], feats[0], jnp.asarray(kf_pose),
                                jnp.asarray(kf_prior), jnp.asarray(prior),
                                jax.random.PRNGKey(odo_cfg.seed), jnp.int32(frame),
                                match_cfg, odo_cfg)
    got = frontend.tracking_step(_port_features(feats[1]), _port_features(feats[0]),
                                 _t(kf_pose), _t(kf_prior), _t(prior), torch.tensor(frame),
                                 port(match_cfg), port(odo_cfg))
    assert bool(want[1]) and bool(got[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=T_ATOL)
    assert int(got[2]) == int(want[2])
    np.testing.assert_array_equal(got[3].index.numpy(), np.asarray(want[3].index))
    np.testing.assert_array_equal(got[3].valid.numpy(), np.asarray(want[3].valid))


# ---------------------------------------------------------------------------
# the sync-free fits
# ---------------------------------------------------------------------------

def _rotation(rng, scale):
    return np.asarray(jse3.exp(jnp.asarray(np.r_[np.zeros(3), rng.normal(size=3) * scale],
                                           jnp.float32)))[:3, :3]


def _fit_inputs(case):
    rng = np.random.default_rng(21)
    n = 64
    src = rng.uniform(-10.0, 10.0, (n, 3)).astype(np.float32)
    src[:, 2] *= [0.3, 0.6, 1.0][["general", "reflection", "collinear"].index(case)]
    src[:, 2] += 25.0
    if case == "collinear":   # every point on one line: the spin about it is free
        src = (np.array([25.0, -3.0, 20.0]) + rng.uniform(-5, 5, (n, 1))
               * np.array([0.6, 0.0, 0.8])).astype(np.float32)
    rot = _rotation(rng, 0.3)
    dst = src @ rot.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.02, (n, 3))
    if case == "reflection":   # a mirrored cloud: only a reflection fits it
        dst = dst * np.array([1.0, 1.0, -1.0])
    return src, dst.astype(np.float32), rng.uniform(0.2, 1.0, n).astype(np.float32)


@pytest.mark.parametrize("case", ["general", "reflection", "collinear"])
def test_rigid_transform_sync_free_matches_jax(case):
    """The Umeyama fit with its rotation from Horn's quaternion against the
    reference's SVD: general and mirrored clouds (the reflection fix) give
    the reference's transform within 1e-4; on collinear points the
    rotation about the line is free, so the fits are held to fit the
    points equally (residuals within 1e-4 m) and to be proper rotations."""
    src, dst, w = _fit_inputs(case)
    want = np.asarray(jrigid.rigid_transform(jnp.asarray(src), jnp.asarray(dst),
                                             jnp.asarray(w)))
    got = rigid.rigid_transform(_t(src), _t(dst), _t(w)).numpy()
    rot = got[:3, :3].astype(np.float64)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(rot) - 1.0) < 1e-5
    np.testing.assert_array_equal(got[3], [0.0, 0.0, 0.0, 1.0])
    if case == "collinear":
        def residual(t):
            return np.linalg.norm(src @ t[:3, :3].T + t[:3, 3] - dst, axis=1)
        np.testing.assert_allclose(residual(got), residual(want), atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=T_ATOL)


def test_rigid_transform_of_zero_weights_is_identity():
    """No weight at all: the reference's SVD of a zero covariance gives the
    identity rotation and a zero translation, and so does the port."""
    src, dst, _ = _fit_inputs("general")
    got = rigid.rigid_transform(_t(src), _t(dst), torch.zeros(len(src))).numpy()
    want = np.asarray(jrigid.rigid_transform(jnp.asarray(src), jnp.asarray(dst),
                                             jnp.zeros(len(src))))
    np.testing.assert_array_equal(got, np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(got, want, atol=T_ATOL)


def test_refine_rigid_gn_matches_jax():
    """The Gauss-Newton polish (its 6x6 solve without a status read) with
    the rotation prior and the depth down-weighting, from a perturbed
    start: within 1e-4 of the reference's."""
    src, dst, w = _fit_inputs("general")
    start = np.asarray(jrigid.rigid_transform(jnp.asarray(src), jnp.asarray(dst),
                                              jnp.asarray(w)))
    start = np.asarray(jse3.exp(jnp.asarray([0.05, -0.02, 0.03, 0.004, -0.003, 0.002],
                                            jnp.float32))) @ start
    comp = np.array([1.0, 1.0, 0.2], np.float32)
    prior = _rotation(np.random.default_rng(2), 0.01) @ start[:3, :3]
    kw = dict(rot_prior_weight=50.0, iters=3)
    want = jrigid.refine_rigid_gn(jnp.asarray(start), jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(w), jnp.asarray(comp),
                                  rot_prior=jnp.asarray(prior), **kw)
    got = rigid.refine_rigid_gn(_t(start), _t(src), _t(dst), _t(w), _t(comp),
                                rot_prior=_t(prior.astype(np.float32)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=T_ATOL)


def test_se3_exp_and_log_match_jax():
    """``exp`` of single and batched tangents (the identity built by tensor
    writes) within 1e-6 of the reference's, the same identity bits, and
    ``log`` (its solve without a status read) within 1e-5, small angles
    included."""
    rng = np.random.default_rng(9)
    xi = rng.normal(size=(16, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-5
    for x in (xi, xi[0]):
        want = np.asarray(jse3.exp(jnp.asarray(x)))
        got = se3.exp(_t(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_array_equal(got[..., 3, :], want[..., 3, :])
        np.testing.assert_allclose(se3.log(_t(want)).numpy(),
                                   np.asarray(jse3.log(jnp.asarray(want))), atol=1e-5)
    inv = se3.inverse(_t(np.asarray(jse3.exp(jnp.asarray(xi[1]))))).numpy()
    np.testing.assert_allclose(inv, np.asarray(jse3.inverse(jse3.exp(jnp.asarray(xi[1])))),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the window with its count on the device
# ---------------------------------------------------------------------------

def test_append_with_device_count_fills_and_slides_like_jax():
    """W=3 over five appends: the masked shift equals the reference's
    branch at every fill level, count (a 0-dim device tensor) included."""
    rng = np.random.default_rng(12)
    frames, _, _ = _chain_scenario(rng, n_kf=5, k_kp=16, drop_prob=0.3)
    frames[2]["valid3d"][::4] = False
    js = jdt.create_window(3, 16)
    ts = device_tracks.create_window(3, 16, "cpu")
    assert ts.count.dim() == 0
    for f in frames:
        args = (f["points3d"], f["valid3d"], f["match_idx"], f["match_ok"],
                f["pose"], f["pose"])
        js = jdt._append(js, *map(jnp.asarray, args))
        ts = device_tracks._append(ts, *map(_t, args))
        for name in ("points3d", "valid3d", "match_idx", "match_ok", "poses", "priors"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
        assert int(ts.count) == int(js.count)
    assert int(ts.count) == 3


def test_keyframe_core_with_device_count_slides_like_jax():
    """``keyframe_core`` at W=3 over five keyframes: the ring, the count
    and the integer stats equal to the reference's after every event, the
    refined poses within 1e-4 m (the existing ring test's bound)."""
    rng = np.random.default_rng(5)
    frames, gt, _ = _chain_scenario(rng, n_kf=5, k_kp=64, drop_prob=0.3)
    cfg = BAConfig(window=3, max_landmarks=64, gn_iters=3,
                   prior_position_weight=1 / 0.15**2, prior_rotation_weight=1 / 0.01**2)
    counts = []
    for js, ts, jr, tr, jst, tst in _ring_run(cfg, frames, gt):
        counts.append(int(ts.count))
        assert int(ts.count) == int(js.count)
        for name in ("valid3d", "match_idx", "match_ok"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
        assert int(tst["landmarks"]) == int(jst["landmarks"])
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    assert counts == [1, 2, 3, 3, 3]


# ---------------------------------------------------------------------------
# the static-buffer step against the eager engine
# ---------------------------------------------------------------------------

def _kept(engine):
    """Copies of what the host holds after a frame: its pose, the last
    keyframe's tensors, the newest window refinement, the deferred VO
    scalars."""
    kf = engine.keyframes[-1]
    held = [engine.trajectory[-1], kf.pose, kf.prior_pose, kf.features.points3d,
            kf.features.valid3d, *kf.features.keypoints]
    if engine._ba_events:
        held.append(engine._ba_events[-1][1])
    if engine._pending_vo:
        held.extend(engine._pending_vo[-1][1:])
    return held, [t.clone() for t in held]


@pytest.mark.parametrize("ba", [True, False])
def test_static_step_equals_eager_engine(sequence, ba):  # noqa: F811
    """The graph's static buffers and body without capture, against the
    eager engine on the same 8 frames (keyframes, window BA on and off):
    the trajectory, keyframes, records and map bit for bit; and every
    value the host kept after frame k unchanged after frame k + 1 ran."""
    rig, frames = sequence
    cfg = _config()
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, ba_every_keyframe=ba))
    cfg, rig, frames = port(cfg), port(rig), port(frames)
    results = {}
    for step in ("eager", "static"):
        engine = pipeline.OnlineReconstructor(cfg, rig, "cpu", _step=step)
        assert (engine._steps is None) == (step == "eager")
        records, held = [], None
        for frame in frames:
            records.append({k: v for k, v in engine.process(frame).items()
                            if not k.startswith("t_")})
            if held is not None:
                for a, b in zip(*held):
                    assert torch.equal(a, b), "a kept value changed"
            held = _kept(engine)
        results[step] = records, engine.finish()
    (want_rec, want), (got_rec, got) = results["eager"], results["static"]
    assert got_rec == want_rec
    assert len(got.keyframe_indices) >= 4
    np.testing.assert_array_equal(got.keyframe_indices, want.keyframe_indices)
    np.testing.assert_array_equal(got.trajectory, want.trajectory)
    np.testing.assert_array_equal(got.map_points, want.map_points)
    np.testing.assert_array_equal(got.map_colors, want.map_colors)
