"""Point-sharded voxel reduction (P3): distributed map downsampling (port
of parallel/voxel_sharded.py).

The point pool is split over the ranks, and downsampling runs in two stages:

1. local: each rank sort + segment-reduces its own shard (as
   mapping/voxel.py does), which removes the duplicates inside the shard;
2. merge: the survivors are either all-gathered and reduced once more on
   every rank (``sharded_voxel_downsample``), or routed to one owner rank
   per voxel and reduced there (``voxel_route_merge``).

Exactness: a centroid of centroids is not the centroid of the points, so
stage 1 carries per-voxel *sums and counts*, never means; stage 2 finishes
the division. The result equals the single-device filter up to the order of
the f32 sums.

The voxel key is one int64 in the reference's (ix, iy * n + iz) order, as
in mapping/voxel.py; the owner hash mixes its two words (ix and iy * n + iz)
exactly as the reference mixes its two 32-bit keys.
"""

from __future__ import annotations

from typing import Tuple

import torch

from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
from online_3d_reconstruction_tpu_torch.mapping.voxel import _SENTINEL, voxel_coords
from online_3d_reconstruction_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_to_all,
    axis_index,
    psum,
)

_MASK32 = 0xFFFFFFFF


def _per_axis(voxel_size: float, bounds: float) -> int:
    per_axis = int(2.0 * bounds / voxel_size) + 2
    if per_axis * per_axis >= 2**31:
        raise ValueError("voxel grid too fine for two-word keys")
    return per_axis


def _segments(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of ``key`` and, per sorted element, the id of its run of
    equal keys: (order, seg_id), ids dense from 0 in key order."""
    key_s, order = torch.sort(key, stable=True)
    new_seg = torch.ones_like(key_s)
    new_seg[1:] = (key_s[1:] != key_s[:-1]).to(key_s.dtype)
    return order, torch.cumsum(new_seg, 0) - 1


def _merge_records(rec: torch.Tensor, key: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum the (M, C) records that share a voxel key. Returns (tot (M, C),
    rep_key (M,)) with the segments' results compacted at the front in key
    order; the slots past the last segment hold zeros and the sentinel."""
    m = rec.shape[0]
    order, seg_id = _segments(key)
    tot = torch.zeros_like(rec).index_add_(0, seg_id, rec[order])
    # every element of a segment carries the same key, so any writer wins
    rep_key = torch.full((m,), _SENTINEL, dtype=torch.int64, device=key.device)
    rep_key[seg_id] = key[order]
    return tot, rep_key


def _local_reduce(points: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
                  voxel_size: float, bounds: float, per_axis: int):
    """Segment-reduce a shard, carrying (sum, count) instead of means:
    (sum_pts (N, 3), sum_col (N, 3), counts (N,), rep_key (N,))."""
    idx = voxel_coords(points, voxel_size, bounds)
    in_bounds = ((idx >= 0) & (idx < per_axis)).all(dim=1) & valid
    key = (idx[:, 0] * per_axis + idx[:, 1]) * per_axis + idx[:, 2]
    key = torch.where(in_bounds, key, _SENTINEL)
    valf = in_bounds.to(torch.float32)[:, None]
    rec = torch.cat([points * valf, colors * valf, valf], dim=1)
    tot, rep_key = _merge_records(rec, key)
    return tot[:, 0:3], tot[:, 3:6], tot[:, 6], rep_key


def owner_of(key: torch.Tensor, per_axis: int, n_dev: int) -> torch.Tensor:
    """The rank that owns each voxel key: the reference's hash
    ``(hi * 2654435761) ^ (lo * 40503) mod n`` of the key's two words in
    uint32 arithmetic, done in int64 masked to 32 bits (torch has no uint32
    multiply on every backend; both factors are below 2^32 and 2^31, so the
    int64 products do not overflow)."""
    hi = torch.div(key, per_axis * per_axis, rounding_mode="floor")
    lo = key - hi * (per_axis * per_axis)
    mix = ((hi * 2654435761) & _MASK32) ^ ((lo * 40503) & _MASK32)
    return mix % n_dev


def stage(points: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
          mesh: Mesh, voxel_size: float, bounds: float, cap: int):
    """This rank's part of the owner-routed merge on its shard of points:
    (points (n * cap, 3), colors, occupied) of the voxels this rank owns,
    and the dropped count in points, summed over the ranks."""
    n_dev = mesh.size
    per_axis = _per_axis(voxel_size, bounds)
    dev = points.device
    # 1. local exact pre-reduction of the own shard
    sum_pts, sum_col, counts, rep_key = _local_reduce(
        points, colors, valid, voxel_size, bounds, per_axis)
    occ = (counts > 0) & (rep_key != _SENTINEL)
    m = counts.shape[0]

    # 2. owner = hash of the voxel key; an empty record goes to the overflow bin
    owner = torch.where(occ, owner_of(torch.where(occ, rep_key, 0), per_axis, n_dev),
                        n_dev)
    # position within the destination's bucket: stable sort by owner, then
    # the rank inside each run
    owner_s, order = torch.sort(owner, stable=True)
    at = torch.arange(m, device=dev)
    seg_start = torch.ones(m, dtype=torch.bool, device=dev)
    seg_start[1:] = owner_s[1:] != owner_s[:-1]
    pos_in_seg = at - torch.cummax(torch.where(seg_start, at, 0), 0).values
    keep = (owner_s < n_dev) & (pos_in_seg < cap)
    # overflow is counted in POINTS (each record carries ``count`` points)
    counts_s = counts[order]
    dropped = torch.where((owner_s < n_dev) & (pos_in_seg >= cap), counts_s,
                          0.0).sum().to(torch.int64)

    # one packed int32 buffer per destination: 7 record words + 2 key words,
    # with one spare row at the end that takes every rejected entry
    rec = torch.cat([sum_pts, sum_col, counts[:, None]], dim=1)[order]
    words = torch.cat([rec.view(torch.int32),
                       rep_key[order].view(torch.int32).reshape(m, 2)], dim=1)
    empty = torch.cat([torch.zeros(7, dtype=torch.int32),
                       torch.tensor([_SENTINEL]).view(torch.int32)]).to(dev)
    buf = empty.repeat(n_dev * cap + 1, 1)
    buf[torch.where(keep, owner_s * cap + pos_in_seg, n_dev * cap)] = words
    # ship bucket d to rank d
    rx = all_to_all(buf[:n_dev * cap], mesh)

    # 3. owner-side exact merge by key over its n_dev * cap records
    rx_key = rx[:, 7:9].contiguous().view(torch.int64).reshape(-1)
    tot, out_key = _merge_records(rx[:, :7].contiguous().view(torch.float32), rx_key)
    tot_cnt = tot[:, 6]
    occupied = (tot_cnt > 0) & (out_key != _SENTINEL)
    denom = tot_cnt.clamp(min=1.0)[:, None]
    out_pts = torch.where(occupied[:, None], tot[:, 0:3] / denom, 0.0)
    out_col = torch.where(occupied[:, None], tot[:, 3:6] / denom, 0.0)
    return out_pts, out_col, occupied, psum(dropped, mesh)


def _shard(mesh: Mesh, *arrays: torch.Tensor):
    """This rank's contiguous share of each (N, ...) array, on its device."""
    n = arrays[0].shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} points not divisible by {mesh.size} devices")
    per = n // mesh.size
    rows = slice(axis_index(mesh) * per, (axis_index(mesh) + 1) * per)
    return [a[rows].to(mesh.device) for a in arrays]


def voxel_route_merge(points: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
                      mesh: Mesh, voxel_size: float, bounds: float = 2048.0,
                      bucket_capacity: int = 0) -> Tuple[PointCloud, torch.Tensor]:
    """Owner-routed voxel merge. Three stages per rank (``stage``):

    1. LOCAL pre-reduction: sort + segment-reduce the own shard once, at
       most one (sum, count, key) record per locally occupied voxel;
    2. route: each record's voxel key hashes to one owner rank; records
       pack into fixed-capacity per-destination buckets and ONE
       ``all_to_all`` of a packed buffer ships them (pre-reduced records,
       not raw points: fewer bytes and less work for the owner);
    3. owner merge: sum the received records BY KEY (sum of sums, exact)
       and divide.

    With an explicit ``bucket_capacity`` c the work after the route is
    O(n * c) per rank: c ~ 2N / n^2 for balanced hashes gives O(N / n) per
    rank. Overflow is *counted*, never silent. The default c = N / n is
    lossless even if every local voxel is unique and hashes to ONE owner.

    points: (N, 3), N divisible by the mesh size; every rank passes the
    whole pool and takes its share. Returns (PointCloud of the ranks' owned
    voxels gathered in rank order, capacity n * n * c, on every rank;
    dropped points (), summed over the ranks).
    """
    pts, cols, val = _shard(mesh, points, colors, valid)
    cap = bucket_capacity or pts.shape[0]
    out_pts, out_col, occupied, dropped = stage(pts, cols, val, mesh, voxel_size,
                                                bounds, cap)
    return PointCloud(points=all_gather(out_pts, mesh), colors=all_gather(out_col, mesh),
                      valid=all_gather(occupied, mesh)), dropped


def sharded_voxel_downsample(points: torch.Tensor, colors: torch.Tensor,
                             valid: torch.Tensor, mesh: Mesh, voxel_size: float,
                             bounds: float = 2048.0) -> PointCloud:
    """Voxel-downsample a (N, 3) pool split over the mesh: each rank reduces
    its share (``_local_reduce``), the (sum, count, key) records are gathered
    and merged on every rank. N must divide by the mesh size. Returns a
    compacted cloud of capacity N on every rank (the semantics of
    ``mapping.voxel.voxel_downsample``)."""
    per_axis = _per_axis(voxel_size, bounds)
    pts, cols, val = _shard(mesh, points, colors, valid)
    sum_pts, sum_col, counts, rep_key = _local_reduce(pts, cols, val, voxel_size,
                                                      bounds, per_axis)
    rec = all_gather(torch.cat([sum_pts, sum_col, counts[:, None]], dim=1), mesh)
    tot, seg_key = _merge_records(rec, all_gather(rep_key, mesh))
    tot_cnt = tot[:, 6]
    denom = tot_cnt.clamp(min=1.0)[:, None]
    return PointCloud(points=tot[:, 0:3] / denom, colors=tot[:, 3:6] / denom,
                      valid=(tot_cnt > 0) & (seg_key != _SENTINEL))
