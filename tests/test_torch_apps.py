"""PyTorch port, apps: the reconstruct CLI on the synthetic oracle and on a
disk folder (with checkpoint and resume), and the depth and BA-solve tools
against the JAX package's apps on the same small arguments, all with
``--device cpu``; ``--device cuda`` without a card raises."""

import json
import os

import numpy as np
import pytest
import torch

from apps import ba_solve as jba_solve
from apps import depth as jdepth
from online_3d_reconstruction_tpu.io.calibration import (
    CameraIntrinsics,
    StereoCalibration,
    stereo_rectify,
)
from online_3d_reconstruction_tpu.io.dataset import SyntheticSequence
from online_3d_reconstruction_tpu.io.synthetic import (
    Plateau,
    SyntheticScene,
    make_survey_trajectory,
)
from online_3d_reconstruction_tpu_torch.apps import ba_solve, depth, reconstruct
from online_3d_reconstruction_tpu_torch.io.export import load_ply, load_trajectory_tum

torch.set_num_threads(2)

# a small run: 96x128, D=16, 128 keypoints, a 50k-point map
SMALL = ["--set", "stereo.height=96", "--set", "stereo.width=128",
         "--set", "stereo.max_disparity=16", "--set", "features.max_keypoints=128",
         "--set", "mapping.map_capacity=50000", "--device", "cpu", "--quiet"]
# the JAX tools' portable path: lax.scan aggregation in f32, as the port's
STEREO = ["--set", "stereo.height=96", "--set", "stereo.width=128",
          "--set", "stereo.max_disparity=16", "--set", "stereo.use_pallas=false",
          "--set", "stereo.cost_dtype=float32"]


def _outputs_read_back(out, frames):
    times, poses = load_trajectory_tum(str(out / "trajectory.tum"))
    assert poses.shape == (frames, 4, 4) and np.isfinite(poses).all()
    pts, cols = load_ply(str(out / "map.ply"))
    assert len(pts) > 100 and np.isfinite(pts).all() and cols.dtype == np.uint8
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert summary["frames"] == frames
    return poses, pts, summary


def _assert_resume_equals(tmp_path, args, frames):
    """Uninterrupted run vs a run cut after frame 3 (snapshots every 2nd
    keyframe) and resumed: the resumed trajectory.tum equals the
    uninterrupted one to its 6 printed decimals, the map has the same size."""
    full, cut = tmp_path / "full", tmp_path / "cut"
    assert reconstruct.main(args + ["--output", str(full)]) == 0
    assert reconstruct.main(args + ["--output", str(cut), "--checkpoint-every", "2",
                                    "--last", "3", "--pcd", "--viewer", "--metrics"]) == 0
    assert (cut / "checkpoints" / "snapshot.npz").exists()
    for name in ("map.pcd", "viewer.html", "metrics.jsonl"):
        assert (cut / name).stat().st_size > 0
    _outputs_read_back(cut, 4)
    assert reconstruct.main(args + ["--output", str(cut), "--checkpoint-every", "2",
                                    "--resume", "--metrics"]) == 0
    want, want_pts, _ = _outputs_read_back(full, frames)
    got, got_pts, _ = _outputs_read_back(cut, frames)
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert len(got_pts) == len(want_pts)
    # the cut run logged frames 0-3; the resumed one reran the frames after
    # its last snapshot and went on to the end
    with open(cut / "metrics.jsonl") as f:
        logged = [json.loads(line)["frame"] for line in f]
    assert logged[:4] == [0, 1, 2, 3] and logged[4] <= 4
    assert logged[4:] == list(range(logged[4], frames))


def test_reconstruct_app_synthetic_resume(tmp_path):
    _assert_resume_equals(tmp_path, ["--synthetic", "6"] + SMALL, 6)


def _write_disk_folder(root, n, height=96, width=128, fx=60.0):
    """n frames of a distorted rig (96x128 unless told otherwise) as a
    user's folder: RGB left and gray right .npy named by timestamp, a
    quaternion flight-log CSV of the frames' priors, and the calibration
    JSON. Returns the frames' priors."""
    cam = CameraIntrinsics(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width,
                           height=height, dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
    calib = StereoCalibration(left=cam, right=cam, translation=np.array([-0.5, 0.0, 0.0]))
    rig = stereo_rectify(calib)
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)])
    data = SyntheticSequence(scene=scene, rig=rig, calib=calib,
                             poses=make_survey_trajectory(n, altitude=15.0, speed=0.6))
    for sub in ("left", "right"):
        os.makedirs(root / sub)
    rows = []
    for i in range(n):
        f = data[i]
        stamp = f"{f.timestamp:.6f}"
        np.save(root / "left" / f"{stamp}.npy", f.color)
        np.save(root / "right" / f"{stamp}.npy", f.right)
        rows.append([f.timestamp, *f.prior_pose[:3, 3], *_quaternion(f.prior_pose[:3, :3])])
    with open(root / "log.csv", "w") as fh:
        fh.write("timestamp,x,y,z,qw,qx,qy,qz\n")
        for row in rows:
            fh.write(",".join(repr(float(v)) for v in row) + "\n")
    side = dict(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width, height=height,
                dist=list(cam.dist))
    with open(root / "calib.json", "w") as fh:
        json.dump({"left": side, "right": side, "translation": [-0.5, 0.0, 0.0]}, fh)
    return np.stack([data[i].prior_pose for i in range(n)])


def _quaternion(r):
    """(w, x, y, z) of a rotation matrix (float64, w > 0 branch suffices for
    the survey's near-nadir attitudes' relative to their own frame)."""
    w = np.sqrt(max(1.0 + np.trace(r), 1e-12)) / 2.0
    return [w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w),
            (r[1, 0] - r[0, 1]) / (4 * w)]


def test_reconstruct_app_disk_folder_resume(tmp_path):
    """The user's path: image folders + CSV log + calibration (so the
    pipeline rectifies), the flight log read back as the frames' priors
    (within 1e-5), and a resumed run equal to the uninterrupted one."""
    from online_3d_reconstruction_tpu_torch.io import ImageFolderSequence

    priors = _write_disk_folder(tmp_path, 6)
    ds = ImageFolderSequence(left_dir=str(tmp_path / "left"),
                             right_dir=str(tmp_path / "right"),
                             flight_log=str(tmp_path / "log.csv"))
    np.testing.assert_allclose(np.stack([f.prior_pose for f in ds]), priors, atol=1e-5)
    args = ["--left", str(tmp_path / "left"), "--right", str(tmp_path / "right"),
            "--flight-log", str(tmp_path / "log.csv"), "--calib",
            str(tmp_path / "calib.json")] + SMALL
    _assert_resume_equals(tmp_path, args, 6)


def test_cli_equals_library_on_the_folder_round_trip(tmp_path):
    """On a 192x256 folder, where VO locks: the CLI's trajectory equals the
    library's ``reconstruct`` on the frames ``ImageFolderSequence`` reads
    (1e-5 m; the TUM file prints 6 decimals), so the app adds nothing of its
    own. It also equals (1e-5 m) the library on the RENDERED frames once
    they carry the folder's two changes: the left gray as the mean of the
    tinted RGB the folder stores (a camera's colour image, not the rendered
    gray) and the priors through the quaternion log. The first moves the
    trajectory by centimetres, the second by under a millimetre."""
    from online_3d_reconstruction_tpu_torch.io import ImageFolderSequence
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import reconstruct as library
    from tests.test_torch_shared import port

    n, (h, w, fx) = 6, (192, 256, 200.0)
    _write_disk_folder(tmp_path, n, h, w, fx)
    argv = ["--left", str(tmp_path / "left"), "--right", str(tmp_path / "right"),
            "--flight-log", str(tmp_path / "log.csv"), "--calib", str(tmp_path / "calib.json"),
            "--set", f"stereo.height={h}", "--set", f"stereo.width={w}",
            "--set", "stereo.max_disparity=32", "--set", "features.max_keypoints=256",
            "--set", "mapping.map_capacity=200000", "--device", "cpu", "--quiet",
            "--output", str(tmp_path / "out")]
    assert reconstruct.main(argv) == 0
    _, cli = load_trajectory_tum(str(tmp_path / "out" / "trajectory.tum"))
    args = reconstruct._parse_args(argv)
    cfg = reconstruct.build_config(args)
    rig = reconstruct._load_rig(args, cfg)
    folder = list(ImageFolderSequence(left_dir=str(tmp_path / "left"),
                                      right_dir=str(tmp_path / "right"),
                                      flight_log=str(tmp_path / "log.csv")))

    def gap(frames):
        got = library(frames, cfg, rig, device="cpu").trajectory
        return float(np.abs(got[:, :3, 3] - cli[:, :3, 3]).max())

    assert gap(folder) < 1e-5
    cam = CameraIntrinsics(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h,
                           dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
    calib = StereoCalibration(left=cam, right=cam, translation=np.array([-0.5, 0.0, 0.0]))
    data = SyntheticSequence(
        scene=SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)]),
        rig=stereo_rectify(calib), calib=calib,
        poses=make_survey_trajectory(n, altitude=15.0, speed=0.6))
    rendered = port([data[i] for i in range(n)])
    mean_gray = [f._replace(left=f.color.mean(axis=-1).astype(np.float32)) for f in rendered]
    logged = [f._replace(prior_pose=g.prior_pose) for f, g in zip(mean_gray, folder)]
    assert gap(logged) < 1e-5
    assert gap(mean_gray) < 1e-3      # the log's rounding alone
    assert gap(rendered) > 1e-2       # the colour image's gray


def _stderr_json(capsys):
    return json.loads(capsys.readouterr().err.strip().splitlines()[-1])


def test_depth_app_matches_jax(tmp_path, capsys):
    """``--synthetic --cloud`` at 96x128, D=16: valid masks equal, disparity
    within 1e-5 px (the sgm stage test's bound), the same reported numbers
    and the same cloud size."""
    assert jdepth.main(["--synthetic", "--cloud", "--output", str(tmp_path / "j")]
                       + STEREO) == 0
    want = _stderr_json(capsys)
    assert depth.main(["--synthetic", "--cloud", "--output", str(tmp_path / "t"),
                       "--device", "cpu"] + STEREO) == 0
    got = _stderr_json(capsys)
    dj, dt = (np.load(tmp_path / d / "disparity.npy") for d in ("j", "t"))
    np.testing.assert_array_equal(dt >= 0, dj >= 0)
    np.testing.assert_allclose(dt, dj, atol=1e-5)
    assert got["device"] == "cpu"
    assert got["valid_fraction"] == want["valid_fraction"] > 0.8
    assert got["bad_gt_1px"] == want["bad_gt_1px"] < 0.02
    assert got["cloud_points"] == want["cloud_points"] > 1000
    np.testing.assert_allclose(got["disparity_range"], want["disparity_range"], atol=1e-5)
    assert len(load_ply(str(tmp_path / "t" / "cloud.ply"))[0]) == got["cloud_points"]


def test_ba_solve_app_matches_jax(tmp_path, capsys):
    """``--selftest`` on a 4-keyframe, 64-landmark bundle: the cost trace
    within 1e-4 relative (the problem's pose perturbation and the solves
    round in f32 on both sides), falling, and the pose error within 1e-5 m;
    the refined poses written to ``--output`` read back."""
    args = ["--selftest", "--window", "4", "--landmarks", "64", "--iters", "3"]
    assert jba_solve.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = tmp_path / "refined.npz"
    assert ba_solve.main(args + ["--device", "cpu", "--output", str(out)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(got["cost_trace"], want["cost_trace"], rtol=1e-4)
    assert got["cost_trace"][-1] < 1e-2 * got["cost_trace"][0]
    assert abs(got["mean_pose_error_m"] - want["mean_pose_error_m"]) < 1e-5
    with np.load(out) as z:
        assert z["poses"].shape == (4, 4, 4) and z["landmarks"].shape == (64, 3)


@pytest.mark.parametrize("ranks", [1, 4])
def test_ba_solve_sharded(capsys, ranks):
    """``--sharded 1`` solves on a mesh of one rank and equals the unsharded
    self-test (cost trace within 1e-6 relative: the same sums on the CPU);
    ``--sharded 4`` with no process group of four raises ``make_mesh``'s
    error."""
    args = ["--selftest", "--window", "4", "--landmarks", "64", "--iters", "3",
            "--device", "cpu"]
    if ranks > 1:
        with pytest.raises(ValueError, match="requested 4 devices, only 1 available"):
            ba_solve.main(args + ["--sharded", str(ranks)])
        return
    assert ba_solve.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ba_solve.main(args + ["--sharded", "1"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(got["cost_trace"], want["cost_trace"], rtol=1e-6)
    assert got["cost_trace"][-1] < 1e-2 * got["cost_trace"][0]
    assert abs(got["mean_pose_error_m"] - want["mean_pose_error_m"]) < 1e-6


@pytest.mark.parametrize("app,args", [
    (reconstruct, ["--synthetic", "2"]),
    (depth, ["--synthetic"]),
    (ba_solve, ["--selftest"]),
], ids=["reconstruct", "depth", "ba_solve"])
def test_apps_refuse_cuda_without_card(tmp_path, monkeypatch, app, args):
    """``--device cuda`` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        app.main(args + ["--output", str(tmp_path / "out")] if app is not ba_solve
                 else args)
