"""Disparity -> colored point cloud (port of geometry/backproject.py).

The whole image is backprojected at once; invalid or out-of-band pixels are
masked, not compacted, so the cloud has a fixed capacity.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class PointCloud(NamedTuple):
    """Fixed-capacity masked point cloud."""

    points: torch.Tensor  # (N, 3) float32
    colors: torch.Tensor  # (N, 3) float32 in [0, 1]
    valid: torch.Tensor   # (N,) bool


def q_matrix(fx: float, fy: float, cx: float, cy: float, baseline: float,
             cx_right: Optional[float] = None,
             device: "torch.device | str" = "cuda") -> torch.Tensor:
    """The 4x4 disparity-to-depth matrix Q of ``cv::stereoRectify``:
    [X Y Z W]^T = Q @ [u v d 1]^T, point = (X, Y, Z) / W. (fy is accepted
    for API parity; a rectified pair shares f = fx = fy.)"""
    del fy
    if cx_right is None:
        cx_right = cx
    return torch.tensor([[1.0, 0.0, 0.0, -cx],
                         [0.0, 1.0, 0.0, -cy],
                         [0.0, 0.0, 0.0, fx],
                         [0.0, 0.0, 1.0 / baseline, (cx - cx_right) / baseline]],
                        dtype=torch.float32, device=device)


def backproject_disparity(
    disparity: torch.Tensor,
    color: torch.Tensor,
    q: torch.Tensor,
    stride: int = 1,
    min_depth: float = 0.1,
    max_depth: float = math.inf,
    invalid_value: float = -1.0,
    color_prestrided: bool = False,
    color_substride: int = 1,
) -> PointCloud:
    """Backproject a (H, W) disparity map to a masked point cloud.

    color: (H, W) gray or (H, W, 3) RGB. ``stride`` subsamples pixels.
    ``color_prestrided``: color already lies on the strided output grid;
    ``color_substride`` s > 1: that grid is s times coarser still, and each
    color serves an s x s block of points.
    """
    h, w = disparity.shape
    dev = disparity.device
    disp = disparity[::stride, ::stride].to(torch.float32)
    hh, ww = disp.shape
    u = torch.arange(0, w, stride, dtype=torch.float32, device=dev)[None, :].expand(hh, ww)
    v = torch.arange(0, h, stride, dtype=torch.float32, device=dev)[:, None].expand(hh, ww)
    uvd1 = torch.stack([u, v, disp, torch.ones_like(disp)], dim=-1)
    xyzw = uvd1 @ q.to(torch.float32).t()
    w_coord = xyzw[..., 3]
    safe_w = torch.where(w_coord.abs() > 1e-12, w_coord, 1e-12)
    xyz = xyzw[..., :3] / safe_w[..., None]
    z = xyz[..., 2]
    valid = (disp > invalid_value + 0.5) & (disp > 0.0)
    valid &= (z > min_depth) & (z < max_depth) & torch.isfinite(z)

    if color.dim() == 2:
        color = color[..., None].expand(*color.shape, 3)
    if color_prestrided:
        if color_substride > 1:
            color = color.repeat_interleave(color_substride, dim=0)
            color = color.repeat_interleave(color_substride, dim=1)
        col = color[:hh, :ww, :3].to(torch.float32)
    else:
        col = color[::stride, ::stride, :3].to(torch.float32)
    if color.dtype == torch.uint8:
        col = col / 255.0

    n = hh * ww
    return PointCloud(
        points=torch.where(valid[..., None], xyz, 0.0).reshape(n, 3),
        colors=col.reshape(n, 3),
        valid=valid.reshape(n),
    )
