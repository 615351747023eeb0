"""Closed circuits flown over the scene, and the flight-log priors.

A circuit is a closed polyline of waypoints at a fixed altitude, flown at
a fixed step a frame: frame i sits at arc length ``i * step``, and the
polyline's length is ``frames * step``, so the frame after the last is the
first and a stream that cycles the circuit steps from lap to lap exactly as
from frame to frame. With every leg a whole number of steps long, every
corner is a frame and every step is a straight ``step`` metres. The camera
looks straight down (nadir) with the yaw of each circuit frame: zero, or a
small wobble drawn once from ``wobble_seed``, so laps repeat it.

The priors are the ground-truth poses with the flight log's noise, drawn
per stream frame index from the run's seed, so laps differ.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from o3r_bench.scene.render import NADIR_ROTATION


def nadir_pose(x: float, y: float, altitude: float, yaw: float = 0.0) -> np.ndarray:
    """World-from-camera pose of a down-looking camera at (x, y, altitude)."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    yaw_rot = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float64)
    pose = np.eye(4)
    pose[:3, :3] = yaw_rot @ NADIR_ROTATION
    pose[:3, 3] = [x, y, altitude]
    return pose


def circuit_poses(waypoints: Sequence[Sequence[float]], step: float, frames: int,
                  altitude: float, yaw_wobble: float = 0.0,
                  wobble_seed: int = 0) -> np.ndarray:
    """The circuit's ``frames`` ground-truth poses (frames, 4, 4) float64.
    Raises ValueError unless the closed polyline is ``frames * step`` long
    with every leg a whole number of steps."""
    pts = np.asarray(waypoints, dtype=np.float64)
    legs = np.roll(pts, -1, axis=0) - pts
    lengths = np.linalg.norm(legs, axis=1)
    steps = lengths / step
    if not np.allclose(steps, np.round(steps), atol=1e-9) or round(steps.sum()) != frames:
        raise ValueError(f"legs of {lengths.tolist()} m are not whole numbers of "
                         f"{step} m steps adding up to {frames} frames")
    yaw = (np.random.default_rng(wobble_seed).normal(0.0, yaw_wobble, frames)
           if yaw_wobble > 0 else np.zeros(frames))
    poses = []
    for p, leg, n in zip(pts, legs, np.round(steps).astype(int)):
        for k in range(n):
            xy = p + leg * (k / n)
            poses.append(nadir_pose(xy[0], xy[1], altitude, float(yaw[len(poses)])))
    return np.stack(poses)


def prior_pose(gt: np.ndarray, seed: int, index: int, translation_sigma: float,
               rotation_sigma: float) -> np.ndarray:
    """The flight log's prior of stream frame ``index``: ``gt`` with
    Gaussian translation noise and a rotation of Gaussian axis-angle noise,
    drawn from (seed, index), as float32."""
    rng = np.random.default_rng([seed, index])
    noisy = np.array(gt, dtype=np.float64)
    noisy[:3, 3] += rng.normal(0.0, translation_sigma, size=3)
    phi = rng.normal(0.0, rotation_sigma, size=3)
    theta = np.linalg.norm(phi)
    if theta > 1e-12:
        axis = phi / theta
        skew = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                         [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(theta) * skew + (1 - np.cos(theta)) * (skew @ skew)
        noisy[:3, :3] = rot @ noisy[:3, :3]
    return noisy.astype(np.float32)
