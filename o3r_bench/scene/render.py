"""The synthetic UAV scene rendered with PyTorch on the card: a copy of the
port's numpy ``io/synthetic.py`` (``SyntheticScene`` through a distorted
``StereoCalibration``), batched over frames.

A textured ground plane (multi-octave value noise from a lattice hash, plus
a nearest-cell albedo speckle) with raised plateaus, seen by a pinhole
camera with radial-tangential distortion: each pixel's ray is found by the
8-step fixed-point undistortion, cast against the plane and the plateau
tops, and shaded; ``supersample`` s averages an s x s grid of subpixel rays
(a box pixel footprint). Geometry and texture run in float64 and int64 as
the numpy version does, and the images are float32 in [0, 1], so the two
agree to float32 rounding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

NADIR_ROTATION = np.diag([1.0, -1.0, -1.0])


@dataclass(frozen=True)
class Scene:
    """The scene's parameters, as ``SyntheticScene`` names them; a plateau
    is (x_min, x_max, y_min, y_max, height)."""

    seed: int = 0
    base_frequency: float = 0.15
    octaves: int = 5
    speckle_amplitude: float = 0.3
    speckle_frequency: float = 10.0
    plateaus: Tuple[Tuple[float, float, float, float, float], ...] = ()
    supersample: int = 1


@dataclass(frozen=True)
class Camera:
    """One camera: pinhole intrinsics, image size and the OpenCV
    (k1, k2, p1, p2, k3) distortion."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    dist: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)


def _hash_lattice(ix: torch.Tensor, iy: torch.Tensor, seed: int) -> torch.Tensor:
    """Lattice hash of int64 cells -> float64 in [0, 1) (wrapping int64)."""
    h = ix * 374761393 + iy * 668265263 + int(np.int64(seed) * np.int64(104729))
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float64) / float(0x1000000)


def _value_noise(x: torch.Tensor, y: torch.Tensor, seed: int, freq: float) -> torch.Tensor:
    fx = x * freq
    fy = y * freq
    ix = torch.floor(fx).to(torch.int64)
    iy = torch.floor(fy).to(torch.int64)
    tx = fx - ix
    ty = fy - iy
    tx = tx * tx * (3.0 - 2.0 * tx)
    ty = ty * ty * (3.0 - 2.0 * ty)
    v00 = _hash_lattice(ix, iy, seed)
    v10 = _hash_lattice(ix + 1, iy, seed)
    v01 = _hash_lattice(ix, iy + 1, seed)
    v11 = _hash_lattice(ix + 1, iy + 1, seed)
    return (v00 * (1 - tx) * (1 - ty) + v10 * tx * (1 - ty)
            + v01 * (1 - tx) * ty + v11 * tx * ty)


def texture(scene: Scene, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Grayscale albedo in [0, 1] at world (x, y), float32."""
    out = torch.zeros_like(x)
    amp_total = 0.0
    for octave in range(scene.octaves):
        amp = 0.5 ** octave
        freq = scene.base_frequency * (2.0 ** octave)
        out += amp * _value_noise(x, y, scene.seed * 31 + octave, freq)
        amp_total += amp
    if scene.speckle_amplitude > 0:
        fx = torch.floor(x * scene.speckle_frequency).to(torch.int64)
        fy = torch.floor(y * scene.speckle_frequency).to(torch.int64)
        out += scene.speckle_amplitude * _hash_lattice(fx, fy, scene.seed * 31 + 555)
        amp_total += scene.speckle_amplitude
    return (out / amp_total).to(torch.float32)


def texture_rgb(scene: Scene, x: torch.Tensor, y: torch.Tensor,
                gray: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 color of the albedo ``gray`` = ``texture(x, y)``."""
    tint = _value_noise(x, y, scene.seed * 31 + 977, scene.base_frequency * 0.5)
    g = gray.to(torch.float64)
    r = torch.clamp(g * (0.8 + 0.4 * tint), 0, 1)
    gg = torch.clamp(g * (0.9 + 0.2 * (1.0 - tint)), 0, 1)
    b = torch.clamp(g * 0.8, 0, 1)
    return torch.stack([r, gg, b], dim=-1).to(torch.float32)


def _surface_hit(scene: Scene, center: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Ray parameter of the nearest hit of the plane z = 0 and the plateau
    tops; ``center`` (B, 3), ``dirs`` (B, H, W, 3) with camera z = 1."""
    cz = center[:, 2, None, None]
    dz = dirs[..., 2]
    dz_safe = torch.where(dz.abs() < 1e-12, -1e-12, dz)
    t_ground = (0.0 - cz) / dz_safe
    t_best = torch.where(t_ground > 0, t_ground, torch.inf)
    for x_min, x_max, y_min, y_max, height in scene.plateaus:
        t_p = (height - cz) / dz_safe
        px = center[:, 0, None, None] + t_p * dirs[..., 0]
        py = center[:, 1, None, None] + t_p * dirs[..., 1]
        inside = ((t_p > 0) & (px >= x_min) & (px <= x_max)
                  & (py >= y_min) & (py <= y_max))
        t_best = torch.where(inside & (t_p < t_best), t_p, t_best)
    return t_best


def _distort(x, y, dist):
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return x_d, y_d


def render_view(scene: Scene, poses: torch.Tensor, cam: Camera,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Views through camera ``cam`` at world-from-camera ``poses`` (B, 4, 4)
    float64: (gray (B, H, W), rgb (B, H, W, 3)) float32 on ``device``."""
    v, u = torch.meshgrid(torch.arange(cam.height, dtype=torch.float64, device=device),
                          torch.arange(cam.width, dtype=torch.float64, device=device),
                          indexing="ij")
    xd = (u - cam.cx) / cam.fx
    yd = (v - cam.cy) / cam.fy
    x, y = xd.clone(), yd.clone()
    for _ in range(8):
        x_hat, y_hat = _distort(x, y, cam.dist)
        x = x + (xd - x_hat)
        y = y + (yd - y_hat)
    poses = poses.to(device=device, dtype=torch.float64)
    rot = poses[:, :3, :3]
    center = poses[:, :3, 3]

    def shade(du, dv):
        cx_ = (x + du / cam.fx)[None]
        cy_ = (y + dv / cam.fy)[None]
        r = rot[:, :, :, None, None]
        dirs = torch.stack([cx_ * r[:, i, 0] + cy_ * r[:, i, 1] + r[:, i, 2]
                            for i in range(3)], dim=-1)
        depth = _surface_hit(scene, center, dirs)
        hx = center[:, 0, None, None] + depth * dirs[..., 0]
        hy = center[:, 1, None, None] + depth * dirs[..., 1]
        gray = texture(scene, hx, hy)
        return gray, texture_rgb(scene, hx, hy, gray)

    ss = max(int(scene.supersample), 1)
    gray = rgb = None
    for i in range(ss):
        for j in range(ss):
            g, c = shade((i + 0.5) / ss - 0.5, (j + 0.5) / ss - 0.5)
            gray = g if gray is None else gray + g
            rgb = c if rgb is None else rgb + c
    inv = float(np.float32(1.0 / (ss * ss)))
    return gray * inv, rgb * inv


def render_stereo(scene: Scene, poses: np.ndarray, left: Camera, right: Camera,
                  r1: np.ndarray, rotation: np.ndarray, translation: np.ndarray,
                  device, batch: int = 8):
    """Raw stereo frames at the rectified-left poses ``poses`` (N, 4, 4):
    the physical left camera is the rectified one rotated by ``r1``, the
    right one sits at the stereo extrinsics (``x_right = rotation @ x_left
    + translation``). Returns host float32 arrays (left (N, H, W), right
    (N, H, W), color (N, H, W, 3)), rendered ``batch`` frames at a time."""
    r1_4 = np.eye(4)
    r1_4[:3, :3] = np.asarray(r1, dtype=np.float64)
    t_rl = np.eye(4)
    t_rl[:3, :3] = np.asarray(rotation, dtype=np.float64)
    t_rl[:3, 3] = np.asarray(translation, dtype=np.float64)
    inv_rl = np.linalg.inv(t_rl)
    n = len(poses)
    out_l = np.empty((n, left.height, left.width), np.float32)
    out_r = np.empty((n, right.height, right.width), np.float32)
    out_c = np.empty((n, left.height, left.width, 3), np.float32)
    for s in range(0, n, batch):
        chunk = np.asarray(poses[s:s + batch], dtype=np.float64)
        pose_left = chunk @ r1_4
        pose_right = pose_left @ inv_rl
        g, c = render_view(scene, torch.from_numpy(pose_left), left, device)
        out_l[s:s + batch] = g.cpu().numpy()
        out_c[s:s + batch] = c.cpu().numpy()
        g, _ = render_view(scene, torch.from_numpy(pose_right), right, device)
        out_r[s:s + batch] = g.cpu().numpy()
    return out_l, out_r, out_c
