"""Global map: fixed-capacity point pool with cursor insert + voxelize
(port of mapping/global_map.py).

The pool's tensors are UPDATED IN PLACE by ``insert_cloud`` and
``flush_staging`` (the reference donated the pool to its jitted updates for
the same reason: a multi-MB copy per frame). The cursor is a 0-dim device
tensor, so inserting never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
from online_3d_reconstruction_tpu_torch.mapping.voxel import voxel_downsample


class GlobalMap(NamedTuple):
    points: torch.Tensor   # (C, 3) float32 world coords
    colors: torch.Tensor   # (C, 3) float32
    valid: torch.Tensor    # (C,) bool
    cursor: torch.Tensor   # () int64 — next insert offset


def create_map(capacity: int, device: "torch.device | str") -> GlobalMap:
    return GlobalMap(
        points=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        colors=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        cursor=torch.zeros((), dtype=torch.int64, device=device),
    )


def _write_at(gmap: GlobalMap, start: torch.Tensor, cloud: PointCloud) -> None:
    """Copy ``cloud`` into the pool's slots [start, start + n) in place."""
    rows = start + torch.arange(cloud.points.shape[0], device=start.device)
    gmap.points.index_copy_(0, rows, cloud.points)
    gmap.colors.index_copy_(0, rows, cloud.colors)
    gmap.valid.index_copy_(0, rows, cloud.valid)


def insert_cloud(gmap: GlobalMap, cloud: PointCloud) -> GlobalMap:
    """Append a fixed-size masked cloud at the cursor, in place. The start
    clamps to capacity - n (the caller voxelizes before the pool fills)."""
    c = gmap.points.shape[0]
    n = cloud.points.shape[0]
    start = torch.clamp(gmap.cursor, max=c - n)
    _write_at(gmap, start, cloud)
    gmap.cursor.copy_(torch.clamp(start + n, max=c))
    return gmap


def downsample_map(gmap: GlobalMap, voxel_size: float,
                   bounds: float = 2048.0) -> GlobalMap:
    """Voxel-reduce + compact the pool; cursor moves to the survivor count."""
    reduced = voxel_downsample(PointCloud(gmap.points, gmap.colors, gmap.valid),
                               voxel_size, bounds)
    return GlobalMap(points=reduced.points, colors=reduced.colors,
                     valid=reduced.valid, cursor=reduced.valid.sum())


def needs_downsample(gmap: GlobalMap, frame_points: int) -> torch.Tensor:
    """True when the next insert would hit the capacity clamp."""
    return gmap.cursor + frame_points >= gmap.points.shape[0]


def flush_staging(gmap: GlobalMap, staging: GlobalMap, voxel_size: float,
                  bounds: float = 2048.0) -> Tuple[GlobalMap, GlobalMap]:
    """Voxelize the staging pool, append its survivors to the main pool and
    empty the staging pool, all in place; returns (main, staging).

    Two-level compaction: the frequent voxel sort runs over the staging pool
    only; the main pool may hold one point per (voxel, flush) pair until
    ``downsample_map`` merges them.
    """
    reduced = voxel_downsample(
        PointCloud(staging.points, staging.colors, staging.valid),
        voxel_size, bounds)
    c = gmap.points.shape[0]
    s = staging.points.shape[0]
    start = torch.clamp(gmap.cursor, max=c - s)
    _write_at(gmap, start, reduced)
    gmap.cursor.copy_(start + reduced.valid.sum())
    for t in staging:
        t.zero_()
    return gmap, staging


def map_to_numpy(gmap: GlobalMap) -> Tuple[np.ndarray, np.ndarray]:
    """The valid points and colors as host numpy arrays."""
    valid = gmap.valid.cpu().numpy()
    return gmap.points.cpu().numpy()[valid], gmap.colors.cpu().numpy()[valid]
