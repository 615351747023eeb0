"""Frame sources (port of io/dataset.py).

``FrameData``, ``SyntheticSequence`` and the flight-log parsing
(``load_flight_log``, ``gps_to_local``, ``match_poses_to_timestamps``) are
the reference package's jax-free code, used as they are. ``flight_log_poses``
and ``ImageFolderSequence`` are ported onto the port's ``se3``: the
reference's import jax inside their bodies. Images decode through the
reference's jax-free native loader (``io.native_loader``: PNG, JPEG, PGM,
PPM, npy), and ``.npy`` also through numpy; no ``cv2`` is needed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from online_3d_reconstruction_tpu.io import native_loader
from online_3d_reconstruction_tpu.io.dataset import (  # noqa: F401
    FrameData,
    SyntheticSequence,
    gps_to_local,
    load_flight_log,
    match_poses_to_timestamps,
)
from online_3d_reconstruction_tpu_torch.geometry import se3

_IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".npy", ".pgm", ".ppm")


def flight_log_poses(log: dict, camera_from_body: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, 4, 4) float32 world-from-camera priors from a parsed flight log:
    attitude from (qw, qx, qy, qz) or (roll, pitch, yaw), else identity."""
    n = len(log["timestamp"])

    def f32(name):
        return torch.as_tensor(np.asarray(log[name], dtype=np.float32))

    if "qw" in log:
        quat = torch.stack([f32("qw"), f32("qx"), f32("qy"), f32("qz")], dim=-1)
        rot = se3.quaternion_to_rotation(quat).numpy()
    elif "roll" in log:
        rot = se3.euler_to_rotation(f32("roll"), f32("pitch"), f32("yaw")).numpy()
    else:
        rot = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3))
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = log["xyz"].astype(np.float32)
    if camera_from_body is not None:
        poses = poses @ camera_from_body[None].astype(np.float32)
    return poses


@dataclass
class ImageFolderSequence:
    """Disk dataset: sorted left/right images named by timestamp, a flight
    log matched to them by nearest timestamp (+ a disparity ``.npy`` dir)."""

    left_dir: str
    right_dir: str
    flight_log: str
    disparity_dir: Optional[str] = None
    max_dt: float = 0.1
    camera_from_body: Optional[np.ndarray] = None

    def __post_init__(self):
        def listing(directory):
            return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                          if f.lower().endswith(_IMAGE_EXTENSIONS))

        self._left = listing(self.left_dir)
        self._right = listing(self.right_dir)
        if len(self._left) != len(self._right):
            raise ValueError(
                f"left/right counts differ: {len(self._left)} vs {len(self._right)}")
        log = load_flight_log(self.flight_log)
        self._poses = flight_log_poses(log, self.camera_from_body)
        # image timestamp = filename stem as float, the common survey format
        self._times = np.array(
            [float(os.path.splitext(os.path.basename(p))[0]) for p in self._left])
        self._assoc = match_poses_to_timestamps(log["timestamp"], self._times, self.max_dt)

    def __len__(self) -> int:
        return len(self._left)

    @staticmethod
    def _load_image(path: str) -> np.ndarray:
        """float32 image; 8-bit formats are scaled to [0, 1]."""
        if native_loader.available() and path.lower().endswith(_IMAGE_EXTENSIONS):
            img = native_loader.read_image(path)
            if img.dtype == np.uint8:
                return img.astype(np.float32) / 255.0
            return img.astype(np.float32)
        if path.endswith(".npy"):
            return np.load(path).astype(np.float32)
        raise IOError(
            f"cannot decode {path}: the native image library native/libo3r_io.so "
            "is unavailable (build it with native/build.sh: g++, libpng, libjpeg), "
            "and without it only .npy frames are read")

    def __getitem__(self, i: int) -> FrameData:
        left = self._load_image(self._left[i])
        right = self._load_image(self._right[i])
        color = left if left.ndim == 3 else np.repeat(left[..., None], 3, axis=-1)
        gray_l = left if left.ndim == 2 else left.mean(axis=-1)
        gray_r = right if right.ndim == 2 else right.mean(axis=-1)
        k = int(self._assoc[i])
        prior = self._poses[k] if k >= 0 else np.eye(4, dtype=np.float32)
        disparity = None
        if self.disparity_dir is not None:
            dpath = os.path.join(
                self.disparity_dir,
                os.path.basename(self._left[i]).rsplit(".", 1)[0] + ".npy")
            if os.path.exists(dpath):
                disparity = np.load(dpath).astype(np.float32)
        return FrameData(
            left=gray_l.astype(np.float32),
            right=gray_r.astype(np.float32),
            color=np.asarray(color, dtype=np.float32),
            prior_pose=prior.astype(np.float32),
            timestamp=float(self._times[i]),
            disparity=disparity,
        )

    def __iter__(self) -> Iterator[FrameData]:
        for i in range(len(self)):
            yield self[i]
