"""Voxel-grid downsampling as sort-by-key + segment reduction (port of
mapping/voxel.py): one centroid point (position and color) per occupied
leaf, pcl::VoxelGrid semantics.

The reference's two-word key (ix, iy * n + iz) packs into one int64 here;
a stable sort keeps equal keys in input order and ``index_add_`` sums each
segment. On CUDA ``index_add_`` adds with atomics in no fixed order, so
centroids can differ from the CPU's in the last float bits.
"""

from __future__ import annotations

import torch

from .backproject import PointCloud

_SENTINEL = torch.iinfo(torch.int64).max


def voxel_coords(points: torch.Tensor, voxel_size: float, bounds: float) -> torch.Tensor:
    """(N, 3) int64 voxel indices; the caller keeps |coord| < bounds."""
    return torch.floor((points + bounds) / voxel_size).to(torch.int64)


def voxel_downsample(cloud: PointCloud, voxel_size: float,
                     bounds: float = 2048.0) -> PointCloud:
    """One centroid per occupied voxel; same capacity out as in, the
    representatives in the leading slots in key order, the rest invalid."""
    n = cloud.points.shape[0]
    dev = cloud.points.device
    per_axis = int(2.0 * bounds / voxel_size) + 2
    if per_axis * per_axis >= 2**31:
        raise ValueError("voxel grid too fine for two-word keys; raise voxel_size")

    idx = voxel_coords(cloud.points, voxel_size, bounds)
    in_bounds = ((idx >= 0) & (idx < per_axis)).all(dim=1) & cloud.valid
    key = (idx[:, 0] * per_axis + idx[:, 1]) * per_axis + idx[:, 2]
    key = torch.where(in_bounds, key, _SENTINEL)
    key_s, order = torch.sort(key, stable=True)

    new_seg = torch.ones(n, dtype=torch.int64, device=dev)
    new_seg[1:] = (key_s[1:] != key_s[:-1]).to(torch.int64)
    seg_id = torch.cumsum(new_seg, 0) - 1

    valf = in_bounds[order].to(torch.float32)[:, None]
    sum_pts = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    sum_pts.index_add_(0, seg_id, cloud.points[order] * valf)
    sum_col = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    sum_col.index_add_(0, seg_id, cloud.colors[order] * valf)
    counts = torch.zeros(n, dtype=torch.float32, device=dev)
    counts.index_add_(0, seg_id, valf[:, 0])
    denom = torch.clamp(counts, min=1.0)[:, None]
    return PointCloud(points=sum_pts / denom, colors=sum_col / denom,
                      valid=counts > 0)
