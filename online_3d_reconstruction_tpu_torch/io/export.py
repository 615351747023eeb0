"""Map and trajectory output (port of io/export.py). The PLY/PCD writers,
the PLY reader and the TUM writer are the reference package's numpy code,
used as they are; ``load_trajectory_tum`` is ported onto the port's ``se3``
(the reference's imports jax)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu.io.export import (  # noqa: F401
    load_ply,
    save_pcd,
    save_ply,
    save_trajectory_tum,
)
from online_3d_reconstruction_tpu_torch.geometry import se3


def load_trajectory_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``t tx ty tz qx qy qz qw`` lines -> (timestamps (N,), poses (N, 4, 4))."""
    rows = np.loadtxt(path).reshape(-1, 8)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
    quat_wxyz = np.stack([rows[:, 7], rows[:, 4], rows[:, 5], rows[:, 6]], axis=1)
    poses[:, :3, :3] = se3.quaternion_to_rotation(
        torch.as_tensor(quat_wxyz, dtype=torch.float32)).numpy()
    poses[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], poses
