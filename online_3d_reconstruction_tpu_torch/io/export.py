"""Map and trajectory output (port of io/export.py): PLY/PCD writers, the PLY
reader and the TUM-format pose log, host-side numpy under the reference's
names; ``load_trajectory_tum`` builds its rotations with the port's ``se3``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.geometry import se3


def _prep(points: np.ndarray, colors: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    points = np.asarray(points, dtype=np.float32)
    if colors is None:
        colors = np.full_like(points, 0.7)
    colors = np.asarray(colors)
    if colors.dtype != np.uint8:
        colors = np.clip(np.asarray(colors, dtype=np.float32) * 255.0, 0, 255).astype(np.uint8)
    return points, colors


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
             binary: bool = True) -> None:
    """Write an (N, 3) cloud (+colors) as PLY."""
    points, colors = _prep(points, colors)
    n = len(points)
    header = (
        "ply\n"
        + ("format binary_little_endian 1.0\n" if binary else "format ascii 1.0\n")
        + f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    if binary:
        rec = np.zeros(
            n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)]
        )
        rec["xyz"] = points
        rec["rgb"] = colors
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(rec.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for p, c in zip(points, colors):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read back a PLY written by save_ply. Returns (points, colors uint8)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            header += line
        text = header.decode("ascii")
        n = int([ln for ln in text.splitlines() if ln.startswith("element vertex")][0].split()[-1])
        binary = "binary_little_endian" in text
        if binary:
            rec = np.frombuffer(
                f.read(n * 15), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)]
            )
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts, cols = [], []
        for _ in range(n):
            vals = f.readline().split()
            pts.append([float(v) for v in vals[:3]])
            cols.append([int(v) for v in vals[3:6]])
        return np.asarray(pts, np.float32), np.asarray(cols, np.uint8)


def save_pcd(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
             binary: bool = True) -> None:
    """Write PCL-compatible PCD v0.7 (x y z rgb, rgb packed float)."""
    points, colors = _prep(points, colors)
    n = len(points)
    rgb_packed = (
        (colors[:, 0].astype(np.uint32) << 16)
        | (colors[:, 1].astype(np.uint32) << 8)
        | colors[:, 2].astype(np.uint32)
    ).view(np.float32) if n else np.zeros(0, np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
        f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {'binary' if binary else 'ascii'}\n"
    )
    data = np.concatenate([points, rgb_packed[:, None]], axis=1).astype(np.float32)
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(data.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for row in data:
                f.write(f"{row[0]} {row[1]} {row[2]} {row[3]:.9e}\n")


def save_trajectory_tum(path: str, poses: np.ndarray,
                        timestamps: Optional[np.ndarray] = None) -> None:
    """TUM format: `t tx ty tz qx qy qz qw` per line (the ATE-tool standard)."""
    poses = np.asarray(poses)
    n = len(poses)
    if timestamps is None:
        timestamps = np.arange(n, dtype=np.float64)
    with open(path, "w") as f:
        for t, pose in zip(timestamps, poses):
            r = pose[:3, :3]
            # rotation matrix -> quaternion (w last per TUM), Shepperd's method
            tr = np.trace(r)
            if tr > 0:
                s = np.sqrt(tr + 1.0) * 2
                qw = 0.25 * s
                qx = (r[2, 1] - r[1, 2]) / s
                qy = (r[0, 2] - r[2, 0]) / s
                qz = (r[1, 0] - r[0, 1]) / s
            else:
                i = int(np.argmax(np.diag(r)))
                j, k = (i + 1) % 3, (i + 2) % 3
                s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
                q = np.zeros(4)
                q[i] = 0.25 * s
                q[3] = (r[k, j] - r[j, k]) / s
                q[j] = (r[j, i] + r[i, j]) / s
                q[k] = (r[k, i] + r[i, k]) / s
                qx, qy, qz, qw = q
            tx, ty, tz = pose[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


def load_trajectory_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``t tx ty tz qx qy qz qw`` lines -> (timestamps (N,), poses (N, 4, 4))."""
    rows = np.loadtxt(path).reshape(-1, 8)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
    quat_wxyz = np.stack([rows[:, 7], rows[:, 4], rows[:, 5], rows[:, 6]], axis=1)
    poses[:, :3, :3] = se3.quaternion_to_rotation(
        torch.as_tensor(quat_wxyz, dtype=torch.float32)).numpy()
    poses[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], poses
