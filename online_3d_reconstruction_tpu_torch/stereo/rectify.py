"""Stereo rectification remap (port of stereo/rectify.py, gather form).

The TPU's banded hat-weight matmul (``remap_bilinear_banded``) stands in
for a gather the TPU serializes; a GPU gathers natively, so only the gather
form is ported.
"""

from __future__ import annotations

import torch


def remap_bilinear(image: torch.Tensor, map_xy: torch.Tensor,
                   fill: float = 0.0) -> torch.Tensor:
    """Sample ``image`` (H, W) or (H, W, C) at ``map_xy`` (H', W', 2) coords.

    map_xy[..., 0] is the source x (column), [..., 1] the source y (row) —
    the cv::remap convention. Pixels whose 2x2 footprint leaves the image
    get ``fill``; integer images are rounded back to their dtype.
    """
    h, w = image.shape[:2]
    x = map_xy[..., 0].to(torch.float32)
    y = map_xy[..., 1].to(torch.float32)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    valid = (x0i >= 0) & (x0i <= w - 2) & (y0i >= 0) & (y0i <= h - 2)
    x0c = x0i.clamp(0, w - 2)
    y0c = y0i.clamp(0, h - 2)

    img = image.to(torch.float32)
    v00 = img[y0c, x0c]
    v10 = img[y0c, x0c + 1]
    v01 = img[y0c + 1, x0c]
    v11 = img[y0c + 1, x0c + 1]
    if image.dim() == 3:
        tx = tx[..., None]
        ty = ty[..., None]
        valid = valid[..., None]
    out = (v00 * (1 - tx) * (1 - ty) + v10 * tx * (1 - ty)
           + v01 * (1 - tx) * ty + v11 * tx * ty)
    out = torch.where(valid, out, fill)
    if not image.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(image.dtype)


def rectify_pair(left: torch.Tensor, right: torch.Tensor,
                 map_left: torch.Tensor, map_right: torch.Tensor):
    """Rectify both views of a stereo pair."""
    return remap_bilinear(left, map_left), remap_bilinear(right, map_right)
