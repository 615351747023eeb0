"""PyTorch port, the slice as a whole: JAX ``reconstruct`` and the port's
``reconstruct(device="cpu")`` on the same frames of a small DISTORTED rig
(so rectification runs), window BA off (on: test_torch_pipeline_ba.py), with
the image pyramid, plus the frame-buffer layout (with the precomputed
disparity planes), the engine's prefetched-buffer entry and its live map."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.config import (
    FeatureConfig,
    MappingConfig,
    OdometryConfig,
    PipelineConfig,
    RuntimeConfig,
    StereoConfig,
)
from online_3d_reconstruction_tpu.io.calibration import (
    CameraIntrinsics,
    StereoCalibration,
    stereo_rectify,
)
from online_3d_reconstruction_tpu.io.dataset import SyntheticSequence
from online_3d_reconstruction_tpu.io.synthetic import Plateau, SyntheticScene, make_survey_trajectory
from online_3d_reconstruction_tpu.runtime import pipeline as jpipe
from online_3d_reconstruction_tpu.utils.metrics import ate_rmse
from online_3d_reconstruction_tpu_torch.odometry import rigid
from online_3d_reconstruction_tpu_torch.runtime import pipeline
from online_3d_reconstruction_tpu_torch.stereo import sgm_cuda
from tests.test_torch_shared import port

torch.set_num_threads(2)
H, W = 192, 256


def _config(metrics_path=""):
    """The reference's pipeline off its TPU takes the exact aggregation
    (``use_pallas=False``); the port's runs what its configuration says, so
    the configuration names the exact storage for both."""
    return PipelineConfig(
        stereo=StereoConfig(height=H, width=W, max_disparity=32, num_paths=8,
                            use_pallas=False, cost_dtype="float32"),
        features=FeatureConfig(max_keypoints=256, fast_threshold=5.0),
        odometry=OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        mapping=MappingConfig(voxel_size=0.25, map_capacity=200_000,
                              frame_point_stride=2, color_stride=4, min_depth=1.0,
                              max_depth=60.0, bounds=512.0, downsample_every=4),
        runtime=RuntimeConfig(keyframe_translation=0.5, ba_every_keyframe=False,
                              metrics_path=metrics_path),
    )


@pytest.fixture(scope="module")
def sequence():
    """The bench's distorted rig and scene at 256x192: 8 survey frames."""
    cam = CameraIntrinsics(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, width=W, height=H,
                           dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
    calib = StereoCalibration(left=cam, right=cam, translation=np.array([-0.5, 0.0, 0.0]))
    rig = stereo_rectify(calib)
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                           supersample=2)
    poses = make_survey_trajectory(8, altitude=15.0, speed=0.6)
    data = SyntheticSequence(scene=scene, rig=rig, poses=poses, calib=calib)
    frames = [data[i] for i in range(len(data))]
    return rig, frames


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run(reconstruct, frames, rig, path, config=None, **kw):
    config = config or _config(str(path))
    if reconstruct is pipeline.reconstruct:   # each package gets its own classes
        frames, config, rig = port(frames), port(config), port(rig)
    result = reconstruct(frames, config, rig, **kw)
    return result, _records(path)


def _angle(a, b):
    """Rotation angle between pose stacks; |Ra - Rb|_F = 2 sqrt(2) sin(t/2)."""
    diff = a[:, :3, :3].astype(np.float64) - b[:, :3, :3].astype(np.float64)
    return 2.0 * np.arcsin(np.linalg.norm(diff, axis=(1, 2)) / (2.0 * np.sqrt(2.0)))


@pytest.fixture(scope="module")
def jax_run(sequence, tmp_path_factory):
    rig, frames = sequence
    return _run(jpipe.reconstruct, frames, rig,
                tmp_path_factory.mktemp("jax") / "metrics.jsonl")


def _jax_samples(seed, frame_idx, iters, n, device):
    """The reference's draw: randint over fold_in(PRNGKey(seed), frame),
    with ``frame_idx`` the port's header index (a tensor) or an int."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), int(frame_idx))
    idx = np.asarray(jax.random.randint(key, (iters, 3), 0, n)).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def test_slice_matches_jax_with_injected_samples(sequence, jax_run, tmp_path, monkeypatch):
    """Same RANSAC hypotheses as the reference. Tolerances: per-frame poses
    within 1e-3 m and 1e-3 rad (the reference rectifies with its banded
    matmul remap and sums in other orders, so a rare keypoint lift or
    inlier differs at f32 rounding, moving a link fit by well under a
    millimetre); map point counts within 0.5% (a voxel near a boundary may
    gain or lose a point from those sub-millimetre shifts)."""
    rig, frames = sequence
    monkeypatch.setattr(rigid, "hypothesis_indices", _jax_samples)
    want, want_rec = jax_run
    got, got_rec = _run(pipeline.reconstruct, frames, rig, tmp_path / "m.jsonl",
                        device="cpu")
    np.testing.assert_array_equal(got.keyframe_indices, want.keyframe_indices)
    assert [r.get("used_vo") for r in got_rec] == [r.get("used_vo") for r in want_rec]
    assert sum(bool(r.get("used_vo")) for r in got_rec) >= 6
    assert got.trajectory.shape == want.trajectory.shape == (8, 4, 4)
    dt = np.linalg.norm(got.trajectory[:, :3, 3] - want.trajectory[:, :3, 3], axis=1)
    assert dt.max() < 1e-3, dt
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): well conditioned near 0
    diff = (got.trajectory[:, :3, :3].astype(np.float64)
            - want.trajectory[:, :3, :3].astype(np.float64))
    angle = 2.0 * np.arcsin(np.linalg.norm(diff, axis=(1, 2)) / (2.0 * np.sqrt(2.0)))
    assert angle.max() < 1e-3, angle
    assert abs(len(got.map_points) - len(want.map_points)) <= 0.005 * len(want.map_points)
    assert got.metrics["frames"] == 8


def test_slice_own_generator_ate(sequence, jax_run, tmp_path):
    """The port's own RANSAC draw: ATE against ground truth within 1.2x of
    the reference's plus 1 cm, and below dead reckoning on the priors."""
    rig, frames = sequence
    got, _ = _run(pipeline.reconstruct, frames, rig, tmp_path / "m.jsonl", device="cpu")
    gt = np.stack([f.gt_pose for f in frames])
    ate, ate_ref = ate_rmse(got.trajectory, gt), ate_rmse(jax_run[0].trajectory, gt)
    assert np.isfinite(ate) and ate <= 1.2 * ate_ref + 0.01, (ate, ate_ref)
    assert ate < ate_rmse(np.stack([f.prior_pose for f in frames]), gt)
    assert np.isfinite(got.map_points).all() and len(got.map_points) > 1000


def test_pack_and_unpack_match_jax(sequence):
    """uint8 frame buffer: identical bytes; device-side unpack identical,
    the frame index read from the header included."""
    _, frames = sequence
    packed = pipeline.pack_frame(port(frames[3]), color_stride=4, frame_index=3)
    np.testing.assert_array_equal(packed, jpipe.pack_frame(frames[3], color_stride=4,
                                                           frame_index=3))
    prior, index, left, right, color, disp = pipeline.unpack_frame(
        torch.from_numpy(packed), H, W, 4)
    jprior, jindex, jleft, jright, jcolor, _ = jpipe.unpack_frame(
        jax.numpy.asarray(packed), H, W, 4, -1.0, False)
    assert disp is None
    assert index.dim() == 0 and int(index) == int(jindex) == 3
    for a, b in ((prior, jprior), (left, jleft), (right, jright), (color, jcolor)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pack_and_unpack_disparity_planes_match_jax(sequence):
    """Offline mode's buffer: the 1/16-px lo/hi planes are byte-equal, and
    the decoded disparity is equal, the 0xFFFF sentinel (negative input)
    decoding to ``invalid_value`` included."""
    _, frames = sequence
    disp = frames[3].disparity.copy()
    disp[::7, ::5] = -1.0
    frame = frames[3]._replace(disparity=disp)
    packed = pipeline.pack_frame(port(frame), True, color_stride=4, frame_index=3)
    np.testing.assert_array_equal(packed, jpipe.pack_frame(frame, True, color_stride=4,
                                                           frame_index=3))
    assert len(packed) == len(pipeline.pack_frame(port(frame), color_stride=4)) + 2 * H * W
    got = pipeline.unpack_frame(torch.from_numpy(packed), H, W, 4, -2.5, True)[-1]
    want = jpipe.unpack_frame(jax.numpy.asarray(packed), H, W, 4, -2.5, True)[-1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == -2.5).sum() >= (disp < 0).sum() > 0


def test_process_with_prefetched_buffer_equals_process(sequence):
    """``process(frame, packed=engine.pack(frame))``, as a numpy buffer or a
    tensor, gives the same record and the same poses, bit for bit, as
    ``process(frame)``."""
    rig, frames = port(sequence)
    runs = []
    for mode in ("none", "numpy", "tensor"):
        engine = pipeline.OnlineReconstructor(port(_config()), rig, device="cpu")
        records = []
        for frame in frames[:4]:
            packed = None if mode == "none" else engine.pack(frame)
            if mode == "tensor":
                packed = torch.from_numpy(packed)
            records.append(engine.process(frame, packed=packed))
        result = engine.finish()
        runs.append(([{k: v for k, v in r.items() if not k.startswith("t_")}
                      for r in records], result))
    for records, result in runs[1:]:
        assert records == runs[0][0]
        np.testing.assert_array_equal(result.trajectory, runs[0][1].trajectory)
        np.testing.assert_array_equal(result.map_points, runs[0][1].map_points)


def test_snapshot_map_matches_jax(sequence, monkeypatch):
    """The live map mid-run (main pool + staging pool + trajectory): the
    same point count within 0.5% and the same poses within 1e-3 m (the
    slice tolerances), and equal to the port's own map and poses."""
    rig, frames = sequence
    monkeypatch.setattr(rigid, "hypothesis_indices", _jax_samples)
    cfg = _config()
    jeng = jpipe.OnlineReconstructor(cfg, rig)
    teng = pipeline.OnlineReconstructor(port(cfg), port(rig), device="cpu")
    for frame in frames[:6]:   # 6 frames: 4 flushed to the main pool, 2 staged
        jeng.process(frame)
        teng.process(port(frame))
    jpts, jcols, jtraj = jeng.snapshot_map()
    pts, cols, traj = teng.snapshot_map()
    assert traj.shape == jtraj.shape == (6, 4, 4)
    assert np.abs(traj[:, :3, 3] - jtraj[:, :3, 3]).max() < 1e-3
    assert pts.shape == cols.shape and cols.min() >= 0.0 and cols.max() <= 1.0
    assert abs(len(pts) - len(jpts)) <= 0.005 * len(jpts)
    assert teng._staged_points > 0 and int(teng.gmap.cursor) > 0
    np.testing.assert_array_equal(traj, torch.stack(teng.trajectory).numpy())


def test_pyramid_slice_matches_jax(sequence, tmp_path, monkeypatch):
    """``features.num_levels=2`` through the whole slice, with the
    reference's RANSAC draws: keyframes and VO gates equal, poses within the
    slice tolerances (1e-3 m, 1e-3 rad), map sizes within 0.5%."""
    rig, frames = sequence
    monkeypatch.setattr(rigid, "hypothesis_indices", _jax_samples)

    def config(path):
        cfg = _config(str(path))
        return cfg.replace(features=dataclasses.replace(cfg.features, num_levels=2))

    want, want_rec = _run(jpipe.reconstruct, frames, rig, tmp_path / "j.jsonl",
                          config(tmp_path / "j.jsonl"))
    got, got_rec = _run(pipeline.reconstruct, frames, rig, tmp_path / "t.jsonl",
                        config(tmp_path / "t.jsonl"), device="cpu")
    np.testing.assert_array_equal(got.keyframe_indices, want.keyframe_indices)
    assert [r.get("used_vo") for r in got_rec] == [r.get("used_vo") for r in want_rec]
    assert sum(bool(r.get("used_vo")) for r in got_rec) >= 6
    dt = np.linalg.norm(got.trajectory[:, :3, 3] - want.trajectory[:, :3, 3], axis=1)
    assert dt.max() < 1e-3, dt
    assert _angle(got.trajectory, want.trajectory).max() < 1e-3
    assert abs(len(got.map_points) - len(want.map_points)) <= 0.005 * len(want.map_points)


def test_cuda_without_card_raises(sequence, monkeypatch):
    """No silent fallback: asking for CUDA where there is none raises."""
    rig, _ = sequence
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.reconstruct([], port(_config()), port(rig), device="cuda")


def test_kernel_wrappers_reject_other_devices():
    with pytest.raises(ValueError, match="device"):
        sgm_cuda.aggregate(torch.zeros((4, 4, 8), dtype=torch.uint8, device="meta"),
                           8.0, 32.0, 4)
    with pytest.raises(ValueError, match="device"):
        sgm_cuda.run_total(torch.zeros((4, 4), device="meta"),
                           torch.zeros((4, 4), device="meta"), 0)
    with pytest.raises(ValueError, match="device"):
        sgm_cuda.scan_pair(torch.zeros((4, 4, 8), device="meta"), 8.0, 32.0)
