"""Frame sources (port of io/dataset.py).

``FrameData``, ``SyntheticSequence`` and the flight-log parsing
(``load_flight_log``, ``gps_to_local``, ``match_poses_to_timestamps``) are
numpy code under the reference's names. ``flight_log_poses`` and
``ImageFolderSequence`` build on the port's ``se3``. Images decode through
the native loader (``io.native_loader``: PNG, JPEG, PGM, PPM, npy), and
``.npy`` also through numpy; no ``cv2`` is needed.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Iterator, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.geometry import se3
from online_3d_reconstruction_tpu_torch.io import native_loader
from online_3d_reconstruction_tpu_torch.io.calibration import RectifiedRig
from online_3d_reconstruction_tpu_torch.io.synthetic import SyntheticScene, perturb_poses

_IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".npy", ".pgm", ".ppm")


class FrameData(NamedTuple):
    """One stereo observation: what the online loop consumes per step."""

    left: np.ndarray               # (H, W) float32 grayscale in [0, 1]
    right: np.ndarray              # (H, W) float32
    color: np.ndarray              # (H, W, 3) float32 in [0, 1]
    prior_pose: np.ndarray         # (4, 4) float32 world-from-camera prior
    timestamp: float
    gt_pose: Optional[np.ndarray] = None       # (4, 4) when known (synthetic)
    disparity: Optional[np.ndarray] = None     # precomputed disparity, if any


def frame_from_numpy(fields: Mapping[str, Any]) -> FrameData:
    """A ``FrameData`` from its fields as plain data (arrays, a float, None
    for what is unknown; e.g. ``frame._asdict()`` of a frame built
    elsewhere); arrays are copied with their dtype kept."""
    values = {}
    for name in FrameData._fields:
        value = fields.get(name)
        if name == "timestamp":
            values[name] = float(value)
        else:
            values[name] = None if value is None else np.array(value)
    return FrameData(**values)


@dataclass
class SyntheticSequence:
    """Render-on-demand synthetic frames with noisy flight-log priors."""

    scene: SyntheticScene
    rig: RectifiedRig
    poses: Sequence[np.ndarray]
    prior_translation_sigma: float = 0.15
    prior_rotation_sigma: float = 0.01
    prior_seed: int = 1
    fps: float = 10.0
    # optional raw-camera mode: render distorted views through this
    # StereoCalibration (the pipeline then rectifies with rig's maps);
    # None renders already-rectified views (identity-map rigs)
    calib: object = None

    def __post_init__(self):
        self._priors = perturb_poses(
            self.poses,
            translation_sigma=self.prior_translation_sigma,
            rotation_sigma=self.prior_rotation_sigma,
            seed=self.prior_seed,
        )

    def __len__(self) -> int:
        return len(self.poses)

    def __iter__(self) -> Iterator[FrameData]:
        for i in range(len(self.poses)):
            yield self[i]

    def __getitem__(self, i: int) -> FrameData:
        frame = self.scene.render_stereo(self.poses[i], self.rig,
                                         calib=self.calib)
        return FrameData(
            left=frame.left,
            right=frame.right,
            color=frame.left_rgb,
            prior_pose=self._priors[i].astype(np.float32),
            timestamp=i / self.fps,
            gt_pose=frame.pose,
            disparity=frame.gt_disparity,
        )


# ---------------------------------------------------------------------------
# Flight-log parsing (C3)
# ---------------------------------------------------------------------------

_EARTH_RADIUS = 6378137.0


def gps_to_local(lat: np.ndarray, lon: np.ndarray, alt: np.ndarray,
                 origin: Optional[np.ndarray] = None) -> np.ndarray:
    """(N,) GPS arrays -> (N, 3) local ENU metres (equirectangular approx).

    The reference converts GPS to a local metric frame before using flight
    poses (SURVEY.md C3); for survey-scale extents (<10 km) the flat-earth
    approximation about the first fix is sub-decimetre.
    """
    lat = np.radians(np.asarray(lat, dtype=np.float64))
    lon = np.radians(np.asarray(lon, dtype=np.float64))
    alt = np.asarray(alt, dtype=np.float64)
    if origin is None:
        origin = np.array([lat[0], lon[0], alt[0]])
    x = (lon - origin[1]) * math.cos(float(origin[0])) * _EARTH_RADIUS
    y = (lat - origin[0]) * _EARTH_RADIUS
    z = alt - origin[2]
    return np.stack([x, y, z], axis=-1).astype(np.float64)


def load_flight_log(path: str) -> dict:
    """Parse a flight log: CSV with header; columns by name.

    Supported columns: ``timestamp``, then either (``lat``, ``lon``, ``alt``)
    or (``x``, ``y``, ``z``), plus attitude as (``roll``, ``pitch``, ``yaw``)
    radians or (``qw``, ``qx``, ``qy``, ``qz``). Returns dict of numpy arrays
    with positions already in the local metric frame.
    """
    with open(path) as f:
        header = [c.strip().lower() for c in f.readline().split(",")]
        rows = [
            [float(v) for v in line.split(",")]
            for line in f
            if line.strip() and not line.startswith("#")
        ]
    data = {name: np.array([r[i] for r in rows]) for i, name in enumerate(header)}
    if "lat" in data:
        data["xyz"] = gps_to_local(data["lat"], data["lon"], data["alt"])
    elif "x" in data:
        data["xyz"] = np.stack([data["x"], data["y"], data["z"]], axis=-1)
    else:
        raise ValueError(f"flight log {path} has neither lat/lon/alt nor x/y/z")
    if "timestamp" not in data:
        raise ValueError(f"flight log {path} lacks a timestamp column")
    return data


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


def match_poses_to_timestamps(pose_times: np.ndarray, image_times: np.ndarray,
                              max_dt: float = 0.1) -> np.ndarray:
    """Nearest-record index per image timestamp; -1 where gap > max_dt."""
    pose_times = np.asarray(pose_times)
    image_times = np.asarray(image_times)
    idx = np.searchsorted(pose_times, image_times)
    idx = np.clip(idx, 1, len(pose_times) - 1)
    left = idx - 1
    choose_left = np.abs(pose_times[left] - image_times) <= np.abs(
        pose_times[idx] - image_times
    )
    best = np.where(choose_left, left, idx)
    dt = np.abs(pose_times[best] - image_times)
    return np.where(dt <= max_dt, best, -1).astype(np.int64)


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
