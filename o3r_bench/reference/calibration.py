"""Stereo calibration: intrinsics, distortion, rectification, and Q.

The reference holds stereo intrinsics/extrinsics and builds rectify maps with
``cv::stereoRectify`` + ``cv::initUndistortRectifyMap`` once at startup
(SURVEY.md §2.1 C4). This module reimplements that math from first principles
in numpy — it runs once on the host; the per-frame remap itself is the device
gather in ``stereo/rectify.py``.

Conventions match OpenCV: pinhole K = [[fx,0,cx],[0,fy,cy],[0,0,1]],
distortion (k1, k2, p1, p2, k3), and stereo extrinsics (R, T) such that
``x_right = R @ x_left + T``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    dist: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)

    @property
    def k_matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )


@dataclass(frozen=True)
class StereoCalibration:
    left: CameraIntrinsics
    right: CameraIntrinsics
    rotation: np.ndarray = field(default_factory=lambda: np.eye(3))  # right-from-left
    translation: np.ndarray = field(default_factory=lambda: np.array([-0.1, 0.0, 0.0]))

    @property
    def baseline(self) -> float:
        return float(np.linalg.norm(self.translation))


@dataclass(frozen=True)
class RectifiedRig:
    """Output of stereo_rectify: everything the pipeline needs per frame."""

    r1: np.ndarray       # 3x3 rectifying rotation, left
    r2: np.ndarray       # 3x3 rectifying rotation, right
    p1: np.ndarray       # 3x4 new projection, left
    p2: np.ndarray       # 3x4 new projection, right
    q: np.ndarray        # 4x4 disparity-to-depth matrix
    map_left: np.ndarray   # (H, W, 2) float32 source coords (x, y) for left
    map_right: np.ndarray  # (H, W, 2) for right
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    width: int
    height: int


_RIG_ARRAYS = ("r1", "r2", "p1", "p2", "q", "map_left", "map_right")


def _rodrigues_log(rot: np.ndarray) -> np.ndarray:
    cos_theta = np.clip((np.trace(rot) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-10:
        return np.zeros(3)
    vee = np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]])
    return vee * theta / (2.0 * np.sin(theta))


def _rodrigues_exp(phi: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(phi)
    if theta < 1e-10:
        return np.eye(3)
    axis = phi / theta
    skew = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * skew + (1.0 - np.cos(theta)) * (skew @ skew)


def _distort(x: np.ndarray, y: np.ndarray, dist) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the OpenCV 5-term radial-tangential model to normalized coords."""
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return x_d, y_d


def init_undistort_rectify_map(
    k: np.ndarray,
    dist,
    r_rect: np.ndarray,
    p_new: np.ndarray,
    size: Tuple[int, int],
) -> np.ndarray:
    """Build the (H, W, 2) map of source pixel coords for each rectified pixel.

    Same math as ``cv::initUndistortRectifyMap``: invert the new projection,
    de-rotate, distort, project through the original K.
    size = (width, height).
    """
    width, height = size
    fx_n, fy_n = p_new[0, 0], p_new[1, 1]
    cx_n, cy_n = p_new[0, 2], p_new[1, 2]

    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    x = (u - cx_n) / fx_n
    y = (v - cy_n) / fy_n
    ones = np.ones_like(x)
    rays = np.stack([x, y, ones], axis=-1) @ np.linalg.inv(r_rect).T
    x_cam = rays[..., 0] / rays[..., 2]
    y_cam = rays[..., 1] / rays[..., 2]

    x_d, y_d = _distort(x_cam, y_cam, dist)
    map_x = k[0, 0] * x_d + k[0, 2]
    map_y = k[1, 1] * y_d + k[1, 2]
    return np.stack([map_x, map_y], axis=-1).astype(np.float32)


def stereo_rectify(calib: StereoCalibration) -> RectifiedRig:
    """Compute rectifying rotations, projections, Q, and remap fields.

    Bouguet's method (the algorithm behind ``cv::stereoRectify``): split the
    inter-camera rotation evenly between the two views, then rotate both so
    the baseline lies along the new +x axis.
    """
    om = _rodrigues_log(np.asarray(calib.rotation, dtype=np.float64))
    r_half_left = _rodrigues_exp(om * 0.5)    # applied to left
    r_half_right = _rodrigues_exp(-om * 0.5)  # applied to right
    t_half = r_half_right @ np.asarray(calib.translation, dtype=np.float64)

    # Minimal rotation taking the (half-rotated) baseline onto the +/- x axis,
    # sign-preserving (cv2 convention): keeps the image upright, t_new_x keeps
    # the sign of t_x (negative for a physical left-right rig).
    norm_t = np.linalg.norm(t_half)
    unit_t = t_half / norm_t
    target = np.array([np.sign(t_half[0]) if t_half[0] != 0 else 1.0, 0.0, 0.0])
    axis = np.cross(unit_t, target)
    sin_a = np.linalg.norm(axis)
    cos_a = float(np.dot(unit_t, target))
    if sin_a < 1e-12:
        r_rect = np.eye(3) if cos_a > 0 else _rodrigues_exp(np.array([0.0, 0.0, np.pi]))
    else:
        r_rect = _rodrigues_exp(axis / sin_a * np.arctan2(sin_a, cos_a))

    r1 = r_rect @ r_half_left
    r2 = r_rect @ r_half_right
    baseline = float(norm_t)
    t_new = r_rect @ t_half  # = [sign(t_x) * baseline, 0, 0]
    t_new_x = float(t_new[0])

    # Shared new intrinsics: average focal length, shared principal point.
    f_new = 0.5 * (calib.left.fy + calib.right.fy)
    cx_new = 0.5 * (calib.left.cx + calib.right.cx)
    cy_new = 0.5 * (calib.left.cy + calib.right.cy)

    p1 = np.array([[f_new, 0, cx_new, 0], [0, f_new, cy_new, 0], [0, 0, 1, 0]], dtype=np.float64)
    p2 = p1.copy()
    # P2's 4th column encodes f * t_x (cv2 convention) so that projecting a
    # *left-rectified-frame* point through P2 lands in the right image. The
    # remap itself uses only the 3x3 part.
    p2[0, 3] = f_new * t_new_x

    # Q maps [u, v, d, 1] -> homogeneous 3D, with Q[3, 2] = -1/t_x so that a
    # physical rig (t_x = -B) yields positive disparity and positive depth.
    q = np.array(
        [
            [1.0, 0.0, 0.0, -cx_new],
            [0.0, 1.0, 0.0, -cy_new],
            [0.0, 0.0, 0.0, f_new],
            [0.0, 0.0, -1.0 / t_new_x, 0.0],
        ],
        dtype=np.float64,
    )

    size = (calib.left.width, calib.left.height)
    map_left = init_undistort_rectify_map(calib.left.k_matrix, calib.left.dist, r1, p1, size)
    map_right = init_undistort_rectify_map(calib.right.k_matrix, calib.right.dist, r2, p2, size)

    return RectifiedRig(
        r1=r1, r2=r2, p1=p1, p2=p2, q=q,
        map_left=map_left, map_right=map_right,
        fx=float(f_new), fy=float(f_new), cx=float(cx_new), cy=float(cy_new),
        baseline=baseline, width=calib.left.width, height=calib.left.height,
    )


