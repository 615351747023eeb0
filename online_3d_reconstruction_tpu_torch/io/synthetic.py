"""Synthetic UAV stereo-scene generator — the framework's test oracle.

The reference repo ships no tests and validates by eye against a surveyed
site (SURVEY.md §4). This module replaces that with an *analytic* oracle: a
textured ground plane (plus optional raised plateaus for depth
discontinuities) rendered through an exact pinhole stereo rig, giving
pixel-exact ground-truth depth, disparity, and trajectory for every test in
the suite.

Host-side numpy only; rendering happens once per test/bench setup.

Conventions: world frame x-east / y-north / z-up, ground plane z = 0.
Camera: +Z optical axis (toward the scene), +X right, +Y down in the image.
A pose is the 4x4 world-from-camera transform. A nadir (straight-down)
camera at altitude h has rotation diag(1, -1, -1) and center (x, y, h).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

NADIR_ROTATION = np.diag([1.0, -1.0, -1.0])


class StereoFrame(NamedTuple):
    left: np.ndarray          # (H, W) float32 grayscale in [0, 1]
    right: np.ndarray         # (H, W) float32
    left_rgb: np.ndarray      # (H, W, 3) float32 in [0, 1]
    depth: np.ndarray         # (H, W) float32 GT camera-z depth of left view
    gt_disparity: np.ndarray  # (H, W) float32 GT disparity (fx * B / Z)
    pose: np.ndarray          # (4, 4) GT world-from-left-camera


def _hash_lattice(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic lattice hash -> float in [0, 1). Unbounded extent."""
    h = (
        ix.astype(np.int64) * np.int64(374761393)
        + iy.astype(np.int64) * np.int64(668265263)
        + np.int64(seed) * np.int64(104729)
    )
    h = (h ^ (h >> 13)) * np.int64(1274126177)
    h = h ^ (h >> 16)
    return ((h & np.int64(0xFFFFFF)).astype(np.float64)) / float(0x1000000)


def _value_noise(x: np.ndarray, y: np.ndarray, seed: int, freq: float) -> np.ndarray:
    """Bilinear value noise over world coords at the given frequency."""
    fx = x * freq
    fy = y * freq
    ix = np.floor(fx).astype(np.int64)
    iy = np.floor(fy).astype(np.int64)
    tx = fx - ix
    ty = fy - iy
    # Smoothstep for C1 continuity (keeps gradients finite for census/FAST).
    tx = tx * tx * (3.0 - 2.0 * tx)
    ty = ty * ty * (3.0 - 2.0 * ty)
    v00 = _hash_lattice(ix, iy, seed)
    v10 = _hash_lattice(ix + 1, iy, seed)
    v01 = _hash_lattice(ix, iy + 1, seed)
    v11 = _hash_lattice(ix + 1, iy + 1, seed)
    return (
        v00 * (1 - tx) * (1 - ty)
        + v10 * tx * (1 - ty)
        + v01 * (1 - tx) * ty
        + v11 * tx * ty
    )


@dataclass(frozen=True)
class Plateau:
    """An axis-aligned raised rectangle: a step depth discontinuity."""

    x_min: float
    x_max: float
    y_min: float
    y_max: float
    height: float


@dataclass
class SyntheticScene:
    seed: int = 0
    base_frequency: float = 0.15   # cycles/metre of the coarsest octave
    octaves: int = 5
    # Sharp high-frequency albedo speckle (gravel/vegetation analog): nearest-
    # neighbor lattice hash, so the image has pixel-scale corners and census
    # contrast at any altitude — smooth value noise alone starves FAST/census
    # when the ground-sample distance is small.
    speckle_amplitude: float = 0.3
    speckle_frequency: float = 10.0  # cells/metre
    plateaus: List[Plateau] = field(default_factory=list)
    # Pixel-footprint anti-aliasing: average an s x s subpixel ray grid per
    # pixel. A real sensor integrates irradiance over the pixel footprint
    # (box PSF at minimum); point sampling (supersample=1) makes the subpixel
    # phase of any texture edge sharper than one pixel physically
    # unobservable, so subpixel feature localization cannot be exercised by
    # the oracle without this. GT depth/disparity stay center-ray exact.
    supersample: int = 1

    def texture(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Multi-octave grayscale albedo in [0, 1] at world (x, y)."""
        out = np.zeros_like(x, dtype=np.float64)
        amp_total = 0.0
        for oct_idx in range(self.octaves):
            amp = 0.5 ** oct_idx
            freq = self.base_frequency * (2.0 ** oct_idx)
            out += amp * _value_noise(x, y, self.seed * 31 + oct_idx, freq)
            amp_total += amp
        if self.speckle_amplitude > 0:
            fx = np.floor(x * self.speckle_frequency).astype(np.int64)
            fy = np.floor(y * self.speckle_frequency).astype(np.int64)
            out += self.speckle_amplitude * _hash_lattice(fx, fy, self.seed * 31 + 555)
            amp_total += self.speckle_amplitude
        return (out / amp_total).astype(np.float32)

    def texture_rgb(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        gray = self.texture(x, y)
        tint = _value_noise(x, y, self.seed * 31 + 977, self.base_frequency * 0.5)
        r = np.clip(gray * (0.8 + 0.4 * tint), 0, 1)
        g = np.clip(gray * (0.9 + 0.2 * (1.0 - tint)), 0, 1)
        b = np.clip(gray * 0.8, 0, 1)
        return np.stack([r, g, b], axis=-1).astype(np.float32)

    def _surface_hit(self, center: np.ndarray, dirs_world: np.ndarray):
        """Ray-cast every pixel: nearest of ground plane and plateau tops.

        dirs_world: (H, W, 3) un-normalized with camera-frame z component 1,
        so the ray parameter t equals camera-frame depth Z.
        """
        dz = dirs_world[..., 2]
        dz_safe = np.where(np.abs(dz) < 1e-12, -1e-12, dz)
        t_ground = (0.0 - center[2]) / dz_safe
        t_best = np.where(t_ground > 0, t_ground, np.inf)
        for plat in self.plateaus:
            t_p = (plat.height - center[2]) / dz_safe
            px = center[0] + t_p * dirs_world[..., 0]
            py = center[1] + t_p * dirs_world[..., 1]
            inside = (
                (t_p > 0)
                & (px >= plat.x_min) & (px <= plat.x_max)
                & (py >= plat.y_min) & (py <= plat.y_max)
            )
            t_best = np.where(inside & (t_p < t_best), t_p, t_best)
        return t_best

    def render_view(self, pose: np.ndarray, fx: float, fy: float, cx: float,
                    cy: float, width: int, height: int):
        """Render one pinhole view. Returns (gray, rgb, depth).

        With ``supersample`` s > 1 the gray/rgb channels average an s x s
        subpixel ray grid (box pixel footprint); depth stays the center ray
        so GT disparity remains analytically exact per pixel.
        """
        rot = pose[:3, :3]
        center = pose[:3, 3]
        u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))

        def shade(du: float, dv: float):
            dirs_cam = np.stack([(u + du - cx) / fx, (v + dv - cy) / fy,
                                 np.ones_like(u)], axis=-1)
            dirs_world = dirs_cam @ rot.T
            depth = self._surface_hit(center, dirs_world)
            hit_x = center[0] + depth * dirs_world[..., 0]
            hit_y = center[1] + depth * dirs_world[..., 1]
            return self.texture(hit_x, hit_y), self.texture_rgb(hit_x, hit_y), depth

        ss = max(int(self.supersample), 1)
        if ss == 1:
            gray, rgb, depth = shade(0.0, 0.0)
            return gray, rgb, depth.astype(np.float32)
        gray = None
        rgb = None
        for i in range(ss):
            for j in range(ss):
                g, c, _ = shade((i + 0.5) / ss - 0.5, (j + 0.5) / ss - 0.5)
                gray = g if gray is None else gray + g
                rgb = c if rgb is None else rgb + c
        # depth/disparity GT from the exact center ray, not the AA average
        _, _, depth = shade(0.0, 0.0)
        inv = np.float32(1.0 / (ss * ss))
        return (gray * inv).astype(np.float32), (rgb * inv).astype(np.float32), depth.astype(np.float32)

    def _render_view_distorted(self, pose: np.ndarray, intr) -> tuple:
        """Render through a distorted camera (CameraIntrinsics).

        Physical model: pixel (u, v) observes along the ray whose normalized
        pinhole coords (x, y) DISTORT to the pixel's normalized position —
        inverted by fixed-point iteration (the standard undistort loop),
        vectorized over the whole grid on the host.
        """
        from online_3d_reconstruction_tpu_torch.io.calibration import _distort

        u, v = np.meshgrid(np.arange(intr.width, dtype=np.float64),
                           np.arange(intr.height, dtype=np.float64))
        xd = (u - intr.cx) / intr.fx
        yd = (v - intr.cy) / intr.fy
        x, y = xd.copy(), yd.copy()
        for _ in range(8):
            x_hat, y_hat = _distort(x, y, intr.dist)
            x += xd - x_hat
            y += yd - y_hat

        rot = pose[:3, :3]
        center = pose[:3, 3]

        def shade(du, dv):
            dirs_cam = np.stack([x + du / intr.fx, y + dv / intr.fy,
                                 np.ones_like(x)], axis=-1)
            dirs_world = dirs_cam @ rot.T
            depth = self._surface_hit(center, dirs_world)
            hx = center[0] + depth * dirs_world[..., 0]
            hy = center[1] + depth * dirs_world[..., 1]
            return self.texture(hx, hy), self.texture_rgb(hx, hy)

        ss = max(int(self.supersample), 1)
        gray = None
        rgb = None
        for i in range(ss):
            for j in range(ss):
                g, c = shade((i + 0.5) / ss - 0.5, (j + 0.5) / ss - 0.5)
                gray = g if gray is None else gray + g
                rgb = c if rgb is None else rgb + c
        inv = np.float32(1.0 / (ss * ss))
        return (gray * inv).astype(np.float32), (rgb * inv).astype(np.float32)

    def render_stereo(self, pose: np.ndarray, rig, calib=None) -> StereoFrame:
        """Render a stereo pair at ``pose`` (left camera pose).

        ``rig`` is a RectifiedRig (fx/fy/cx/cy/baseline/width/height). With
        ``calib`` None the views are rendered already-rectified (identity-map
        rigs, the pipeline skips remap). Passing a StereoCalibration renders
        RAW views through each camera's K + distortion instead — the
        reference's actual input (SURVEY.md C4: rectification is in the
        per-frame loop). ``pose`` is always the RECTIFIED-left-camera pose
        (the frame the pipeline estimates); the physical camera pose is
        derived through the rig's rectifying rotation, so depth/gt_disparity/
        gt pose all describe the rectified left view in both modes.
        """
        left, left_rgb, depth = self.render_view(
            pose, rig.fx, rig.fy, rig.cx, rig.cy, rig.width, rig.height
        )
        if calib is None:
            pose_right = pose @ np.array(
                [[1, 0, 0, rig.baseline], [0, 1, 0, 0], [0, 0, 1, 0],
                 [0, 0, 0, 1]], dtype=np.float64,
            )
            right, _, _ = self.render_view(
                pose_right, rig.fx, rig.fy, rig.cx, rig.cy, rig.width, rig.height
            )
        else:
            # physical-left = rectified-left rotated by R1 (x_rect = R1 x_phys
            # => world-from-phys = world-from-rect @ R1)
            r1 = np.eye(4)
            r1[:3, :3] = np.asarray(rig.r1, dtype=np.float64)
            pose_left = pose @ r1
            # world-from-right = world-from-left @ inv(right-from-left)
            t_rl = np.eye(4)
            t_rl[:3, :3] = np.asarray(calib.rotation, dtype=np.float64)
            t_rl[:3, 3] = np.asarray(calib.translation, dtype=np.float64)
            pose_right = pose_left @ np.linalg.inv(t_rl)
            left, left_rgb = self._render_view_distorted(pose_left, calib.left)
            right, _ = self._render_view_distorted(pose_right, calib.right)
        gt_disp = (rig.fx * rig.baseline / np.maximum(depth, 1e-6)).astype(np.float32)
        gt_disp = np.where(np.isfinite(depth), gt_disp, -1.0).astype(np.float32)
        return StereoFrame(
            left=left, right=right, left_rgb=left_rgb,
            depth=depth, gt_disparity=gt_disp, pose=pose.astype(np.float32),
        )


def nadir_pose(x: float, y: float, altitude: float, yaw: float = 0.0) -> np.ndarray:
    """World-from-camera pose of a down-looking camera at (x, y, altitude)."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    yaw_rot = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float64)
    pose = np.eye(4)
    pose[:3, :3] = yaw_rot @ NADIR_ROTATION
    pose[:3, 3] = [x, y, altitude]
    return pose


def make_survey_trajectory(
    num_frames: int,
    altitude: float = 30.0,
    speed: float = 1.5,
    row_length: float = 40.0,
    row_spacing: float = 8.0,
    yaw_wobble: float = 0.03,
    seed: int = 0,
) -> List[np.ndarray]:
    """Lawnmower survey pattern — the UAV mapping flight the reference targets."""
    rng = np.random.default_rng(seed)
    poses = []
    x, y = 0.0, 0.0
    direction = 1.0
    for _ in range(num_frames):
        yaw = float(rng.normal(0.0, yaw_wobble))
        poses.append(nadir_pose(x, y, altitude, yaw))
        x += direction * speed
        if x > row_length or x < 0.0:
            x = np.clip(x, 0.0, row_length)
            y += row_spacing
            direction = -direction
    return poses


def make_orbit_trajectory(
    num_frames: int, radius: float = 15.0, altitude: float = 25.0, seed: int = 0
) -> List[np.ndarray]:
    """Circular orbit with yaw tracking — exercises rotation estimation."""
    del seed
    poses = []
    for i in range(num_frames):
        ang = 2.0 * np.pi * i / max(num_frames, 1) * 0.25
        poses.append(
            nadir_pose(radius * np.cos(ang), radius * np.sin(ang), altitude, yaw=ang)
        )
    return poses


def perturb_poses(
    poses: Sequence[np.ndarray],
    translation_sigma: float = 0.15,
    rotation_sigma: float = 0.01,
    seed: int = 1,
) -> List[np.ndarray]:
    """Simulate noisy flight-log pose priors from GT poses (SURVEY.md C3)."""
    rng = np.random.default_rng(seed)
    out = []
    for pose in poses:
        noisy = pose.copy()
        noisy[:3, 3] += rng.normal(0.0, translation_sigma, size=3)
        phi = rng.normal(0.0, rotation_sigma, size=3)
        theta = np.linalg.norm(phi)
        if theta > 1e-12:
            axis = phi / theta
            skew = np.array(
                [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
            )
            rot = np.eye(3) + np.sin(theta) * skew + (1 - np.cos(theta)) * (skew @ skew)
            noisy[:3, :3] = rot @ noisy[:3, :3]
        out.append(noisy)
    return out
