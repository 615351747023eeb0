"""Voxel-grid downsampling as sort-by-key + segment reduction (port of
mapping/voxel.py): one centroid point (position and color) per occupied
leaf, pcl::VoxelGrid semantics.

The reference's two-word key (ix, iy * n + iz) packs into one int64 here;
a stable sort keeps equal keys in input order and each segment is summed in
that order. On CUDA the reduction is K5 (csrc/voxel_reduce.cu): the keys as
PyTorch computes them on the card, then each voxel summed in sorted order
with no atomics, so the card's centroids are the CPU's bits given the same
keys, and the same from run to run. The keys themselves can differ between
the devices for a point within a float32 rounding of a voxel face, where
1 / voxel_size is inexact: PyTorch divides by the voxel size on the CPU and
multiplies by its float32 reciprocal on the card (as XLA does on both).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
from online_3d_reconstruction_tpu_torch.utils.cuda_build import (
    check,
    launch,
    load_kernels,
    on_card,
)

_SENTINEL = torch.iinfo(torch.int64).max

# K5 reductions run (one per voxel_downsample on the card: 3 kernel launches,
# a stable sort and a cumsum)
launch_counts: Dict[str, int] = {"voxel_reduce": 0}


def voxel_coords(points: torch.Tensor, voxel_size: float, bounds: float) -> torch.Tensor:
    """(N, 3) int64 voxel indices; the caller keeps |coord| < bounds."""
    return torch.floor((points + bounds) / voxel_size).to(torch.int64)


def _per_axis(voxel_size: float, bounds: float) -> int:
    per_axis = int(2.0 * bounds / voxel_size) + 2
    if per_axis * per_axis >= 2**31:
        raise ValueError("voxel grid too fine for two-word keys; raise voxel_size")
    return per_axis


def voxel_keys(cloud: PointCloud, voxel_size: float, bounds: float = 2048.0) -> torch.Tensor:
    """(N,) int64 packed voxel keys, the sentinel where a point is invalid or
    outside the grid."""
    per_axis = _per_axis(voxel_size, bounds)
    idx = voxel_coords(cloud.points, voxel_size, bounds)
    in_bounds = ((idx >= 0) & (idx < per_axis)).all(dim=1) & cloud.valid
    key = (idx[:, 0] * per_axis + idx[:, 1]) * per_axis + idx[:, 2]
    return torch.where(in_bounds, key, _SENTINEL)


def segment_centroids_plain(cloud: PointCloud, key: torch.Tensor) -> PointCloud:
    """The centroid of each run of equal keys (the sentinel's dropped), in
    key order in the leading slots, the rest invalid."""
    n = cloud.points.shape[0]
    dev = cloud.points.device
    key_s, order = torch.sort(key, stable=True)

    new_seg = torch.ones(n, dtype=torch.int64, device=dev)
    new_seg[1:] = (key_s[1:] != key_s[:-1]).to(torch.int64)
    seg_id = torch.cumsum(new_seg, 0) - 1

    valf = (key_s != _SENTINEL).to(torch.float32)[:, None]
    sum_pts = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    sum_pts.index_add_(0, seg_id, cloud.points[order] * valf)
    sum_col = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    sum_col.index_add_(0, seg_id, cloud.colors[order] * valf)
    counts = torch.zeros(n, dtype=torch.float32, device=dev)
    counts.index_add_(0, seg_id, valf[:, 0])
    denom = torch.clamp(counts, min=1.0)[:, None]
    return PointCloud(points=sum_pts / denom, colors=sum_col / denom,
                      valid=counts > 0)


def voxel_downsample_plain(cloud: PointCloud, voxel_size: float,
                           bounds: float = 2048.0) -> PointCloud:
    """Plain PyTorch K5: ``voxel_keys``, then ``segment_centroids_plain``
    (``index_add_`` scatters; on CUDA their atomics add in no fixed order)."""
    return segment_centroids_plain(cloud, voxel_keys(cloud, voxel_size, bounds))


def _check_cloud(cloud: PointCloud) -> None:
    points, colors, valid = cloud
    n = points.shape[0]
    if (points.dtype != torch.float32 or colors.dtype != torch.float32
            or valid.dtype != torch.bool):
        raise ValueError(f"K5 takes float32 points and colors and bool validity, got "
                         f"{points.dtype}, {colors.dtype}, {valid.dtype}")
    if points.shape != (n, 3) or colors.shape != (n, 3) or valid.shape != (n,):
        raise ValueError(f"K5 takes (N, 3), (N, 3), (N,) tensors, got {tuple(points.shape)}, "
                         f"{tuple(colors.shape)}, {tuple(valid.shape)}")
    if not (points.is_contiguous() and colors.is_contiguous() and valid.is_contiguous()):
        raise ValueError("K5 takes contiguous points, colors and validity")
    if colors.device != points.device or valid.device != points.device:
        raise ValueError(f"K5 takes one device, got {points.device}, {colors.device}, "
                         f"{valid.device}")
    if n >= 2**31:
        raise ValueError(f"K5 takes fewer than 2^31 points, got {n}")


def voxel_downsample(cloud: PointCloud, voxel_size: float,
                     bounds: float = 2048.0) -> PointCloud:
    """One centroid per occupied voxel; same capacity out as in, the
    representatives in the leading slots in key order, the rest invalid.

    On CUDA: K5 (``k5_launches``), no atomics; ``launch_counts
    ["voxel_reduce"]`` counts it. On the CPU: ``voxel_downsample_plain``.
    Raises ValueError, on either device, for a grid too fine for the key or
    tensors K5 does not take (dtype, shape, contiguity, device).
    """
    _per_axis(voxel_size, bounds)
    _check_cloud(cloud)
    if not on_card(cloud.points):
        return voxel_downsample_plain(cloud, voxel_size, bounds)
    return k5_launches(load_kernels(), functools.partial(launch, cloud.points.device),
                       cloud, voxel_size, bounds)


def k5_launches(lib, launch, cloud: PointCloud, voxel_size: float,
                bounds: float) -> PointCloud:
    """K5's launches for ``voxel_downsample`` (checked arguments):
    ``launch(entry, *args)`` calls an entry point of ``lib`` on the stream
    and returns its error code. The keys: ``(p + bounds) * (1 / voxel_size)``
    in float32, as PyTorch computes ``voxel_coords`` on the card."""
    points, colors, valid = cloud
    n = points.shape[0]
    dev = points.device
    out = PointCloud(torch.empty((n, 3), dtype=torch.float32, device=dev),
                     torch.empty((n, 3), dtype=torch.float32, device=dev),
                     torch.empty(n, dtype=torch.bool, device=dev))
    if n == 0:
        return out
    inv = np.float32(1.0) / np.float32(voxel_size)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    check(lib, launch(lib.o3r_voxel_keys, points.data_ptr(), valid.data_ptr(), key.data_ptr(),
                      n, float(np.float32(bounds)), float(inv), _per_axis(voxel_size, bounds)),
          "voxel_keys kernel")
    key_s, order = torch.sort(key, stable=True)
    head = torch.empty(n, dtype=torch.int32, device=dev)
    check(lib, launch(lib.o3r_voxel_heads, key_s.data_ptr(), head.data_ptr(), n),
          "voxel_heads kernel")
    slot = torch.cumsum(head, 0, dtype=torch.int32)
    check(lib, launch(lib.o3r_voxel_reduce, key_s.data_ptr(), order.data_ptr(), slot.data_ptr(),
                      points.data_ptr(), colors.data_ptr(), out.points.data_ptr(),
                      out.colors.data_ptr(), out.valid.data_ptr(), n),
          "voxel_reduce kernel")
    launch_counts["voxel_reduce"] += 1
    return out
