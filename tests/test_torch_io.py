"""PyTorch port, io: flight-log poses, the image-folder dataset and the TUM
trajectory reader against the JAX package's on the same files."""

import os

import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.io import dataset as jdataset
from online_3d_reconstruction_tpu.io import export as jexport
from online_3d_reconstruction_tpu_torch.io import dataset, export

torch.set_num_threads(2)


def _write_log(path, columns, rows):
    with open(path, "w") as f:
        f.write(",".join(columns) + "\n")
        for row in rows:
            f.write(",".join(repr(float(v)) for v in row) + "\n")


def _log_rows(kind, n, rng):
    t = np.arange(n) * 0.1
    xyz = rng.normal(0.0, 20.0, size=(n, 3))
    if kind == "quaternion":
        q = rng.normal(size=(n, 4))
        return ["timestamp", "x", "y", "z", "qw", "qx", "qy", "qz"], np.column_stack([t, xyz, q])
    if kind == "euler":
        rpy = rng.uniform(-np.pi, np.pi, size=(n, 3))
        return ["timestamp", "x", "y", "z", "roll", "pitch", "yaw"], np.column_stack([t, xyz, rpy])
    gps = np.column_stack([47.0 + rng.normal(0, 1e-3, n), 8.0 + rng.normal(0, 1e-3, n),
                           400.0 + rng.normal(0, 5.0, n)])
    return ["timestamp", "lat", "lon", "alt"], np.column_stack([t, gps])


@pytest.mark.parametrize("kind", ["quaternion", "euler", "position_only"])
def test_flight_log_poses_match_jax(tmp_path, kind):
    """Quaternion, Euler and GPS position-only logs, with and without a
    camera-from-body transform: float32 poses within 2e-6 (the attitude's
    3x3 products and the quaternion norm round in other orders; positions
    are the same float32 casts on both sides)."""
    rng = np.random.default_rng(7)
    columns, rows = _log_rows(kind, 9, rng)
    path = str(tmp_path / "log.csv")
    _write_log(path, columns, rows)
    log = dataset.load_flight_log(path)
    body = np.eye(4)
    body[:3, :3] = np.diag([1.0, -1.0, -1.0])
    body[:3, 3] = [0.1, 0.0, -0.2]
    for cam in (None, body):
        got = dataset.flight_log_poses(log, cam)
        want = jdataset.flight_log_poses(log, cam)
        assert got.dtype == want.dtype == np.float32 and got.shape == (9, 4, 4)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)


def _write_folder(root, n, rng, with_disparity):
    for sub in ("left", "right", "disp"):
        os.makedirs(root / sub)
    stamps = [f"{0.1 * i:.6f}" for i in range(n)]
    for i, stamp in enumerate(stamps):
        np.save(root / "left" / f"{stamp}.npy", rng.random((16, 24, 3)).astype(np.float32))
        np.save(root / "right" / f"{stamp}.npy", rng.random((16, 24)).astype(np.float32))
        if with_disparity and i != 1:   # frame 1 has no map
            np.save(root / "disp" / f"{stamp}.npy", rng.random((16, 24)) * 8.0)
    columns, rows = _log_rows("quaternion", n + 2, rng)
    rows[:, 0] = np.arange(n + 2) * 0.1 + 0.004
    _write_log(str(root / "log.csv"), columns, rows)


def test_image_folder_matches_jax(tmp_path):
    """An .npy folder (RGB left, gray right), a quaternion CSV log matched
    by nearest timestamp and a disparity folder with one map missing:
    every frame equal to the JAX dataset's, the priors within 2e-6."""
    _write_folder(tmp_path, 4, np.random.default_rng(3), with_disparity=True)
    kw = dict(left_dir=str(tmp_path / "left"), right_dir=str(tmp_path / "right"),
              flight_log=str(tmp_path / "log.csv"), disparity_dir=str(tmp_path / "disp"))
    got, want = dataset.ImageFolderSequence(**kw), jdataset.ImageFolderSequence(**kw)
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        for name in ("left", "right", "color"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        np.testing.assert_allclose(a.prior_pose, b.prior_pose, atol=2e-6)
        assert a.timestamp == b.timestamp
        if i == 1:
            assert a.disparity is None and b.disparity is None
        else:
            np.testing.assert_array_equal(a.disparity, b.disparity)
    assert got[0].left.shape == (16, 24) and got[0].color.shape == (16, 24, 3)


def test_image_without_a_decoder_names_the_build(tmp_path, monkeypatch):
    """Without the native library only .npy decodes (there is no cv2
    fallback): a PNG then raises naming the file and native/build.sh."""
    png = tmp_path / "0.000000.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n")
    npy = tmp_path / "0.100000.npy"
    np.save(npy, np.full((2, 3), 0.5, np.float32))
    monkeypatch.setattr(dataset.native_loader, "available", lambda: False)
    with pytest.raises(IOError, match=r"0\.000000\.png.*native/build\.sh"):
        dataset.ImageFolderSequence._load_image(str(png))
    np.testing.assert_array_equal(dataset.ImageFolderSequence._load_image(str(npy)),
                                  np.full((2, 3), 0.5, np.float32))


def test_tum_roundtrip_matches_jax(tmp_path):
    """Poses written by the shared TUM writer read back by both readers:
    timestamps equal, poses within 2e-6 (the 6-decimal text, then the same
    quaternion arithmetic); within 1e-5 of what was written, positions
    within 5e-6 (6 decimals, then a float32 cast at up to 60 m)."""
    rng = np.random.default_rng(2)
    from online_3d_reconstruction_tpu_torch.geometry import se3

    poses = se3.exp(torch.as_tensor(rng.normal(0, 0.8, size=(12, 6)), dtype=torch.float32))
    poses = poses.numpy()
    poses[:, :3, 3] *= 20.0
    path = str(tmp_path / "traj.tum")
    export.save_trajectory_tum(path, poses, np.arange(12) * 0.5)
    t_got, got = export.load_trajectory_tum(path)
    t_want, want = jexport.load_trajectory_tum(path)
    np.testing.assert_array_equal(t_got, t_want)
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(got[:, :3, :3], poses[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(got[:, :3, 3], poses[:, :3, 3], atol=5e-6)
