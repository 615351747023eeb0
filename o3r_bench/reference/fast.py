"""FAST corner detection with tiled retention (port of features/fast.py).

Dense and static-shape like the reference: the 16-pixel circle test is 16
shifted images plus a windowed-sum arc check, non-max suppression is a max
pool, retention is top-k per spatial tile then a global top-k to the fixed
keypoint capacity. Top-k is a stable descending sort, so equal scores keep
the lower index first, as ``lax.top_k`` does (``torch.topk`` promises no
order on ties, and FAST scores tie often).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order.
CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shifted_stack(image: torch.Tensor) -> torch.Tensor:
    """(16, H, W) circle-neighbour values, edge-replicated borders."""
    pad = 3
    padded = F.pad(image[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    h, w = image.shape
    return torch.stack([padded[dy + pad:dy + pad + h, dx + pad:dx + pad + w]
                        for dy, dx in CIRCLE16])


def _sum16(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading 16 circle positions, in circle order."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _score_maps(image: torch.Tensor, threshold: float, arc: int):
    """(gated, excess) FAST score maps: ``gated`` is 0 where the contiguous
    arc test fails (ranking / NMS); ``excess`` is the ungated summed
    threshold excess, the continuous surface the subpixel fit reads."""
    neighbors = _shifted_stack(image)
    center = image[None]
    bright = (neighbors > center + threshold).to(torch.float32)
    dark = (neighbors < center - threshold).to(torch.float32)

    def has_arc(mask16: torch.Tensor) -> torch.Tensor:
        wrapped = torch.cat([mask16, mask16[:arc - 1]], dim=0)
        csum = torch.cumsum(wrapped, dim=0)
        csum = torch.cat([torch.zeros_like(csum[:1]), csum], dim=0)
        return (csum[arc:] - csum[:-arc]).amax(dim=0) >= arc

    is_corner = has_arc(bright) | has_arc(dark)
    excess_b = _sum16(torch.clamp(neighbors - center - threshold, min=0.0))
    excess_d = _sum16(torch.clamp(center - threshold - neighbors, min=0.0))
    excess = torch.maximum(excess_b, excess_d)
    return torch.where(is_corner, excess, 0.0), excess


def _nms(score: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep only local maxima within a (2r+1)^2 window."""
    if radius <= 0:
        return score
    local_max = F.max_pool2d(score[None, None], 2 * radius + 1, stride=1,
                             padding=radius)[0, 0]
    return torch.where(score >= local_max, score, 0.0)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, lower index
    first among equals."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def detect_keypoints(
    image: torch.Tensor,
    max_keypoints: int = 512,
    threshold: float = 20.0 / 255.0,
    arc: int = 9,
    nms_radius: int = 3,
    border: int = 20,
    grid_tiles: Tuple[int, int] = (4, 4),
    subpixel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_keypoints`` FAST corners with tiled retention.

    Returns (xy (K, 2) float32 [x, y], score (K,), valid (K,) bool); slots
    past the detected corners have score 0 and are invalid.
    """
    h, w = image.shape
    dev = image.device
    gated, excess = _score_maps(image, threshold, arc)
    score = _nms(gated, nms_radius)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(in_border, score, 0.0)

    ty, tx = grid_tiles
    padded = F.pad(score, (0, (-w) % tx, 0, (-h) % ty))
    hh, ww = padded.shape
    th, tw = hh // ty, ww // tx
    k_per_tile = min(-(-max_keypoints // (ty * tx)) * 2, th * tw)
    tiles = padded.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(ty * tx, th * tw)
    tile_scores, tile_idx = _top_k(tiles, k_per_tile)

    tile_id = torch.arange(ty * tx, device=dev)
    y0 = ((tile_id // tx) * th)[:, None] + tile_idx // tw
    x0 = ((tile_id % tx) * tw)[:, None] + tile_idx % tw
    top_scores, top_i = _top_k(tile_scores.reshape(-1), max_keypoints)
    xy = torch.stack([x0.reshape(-1)[top_i].to(torch.float32),
                      y0.reshape(-1)[top_i].to(torch.float32)], dim=-1)
    valid = top_scores > 0.0
    if subpixel:
        xy = refine_subpixel_score(excess, xy, valid)
    return xy, top_scores, valid


def refine_subpixel_score(excess: torch.Tensor, xy: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Per-axis 3-point parabola fit of the peak on the ungated excess
    surface, offsets clamped to +-0.5 px (translation-equivariant subpixel
    keypoints; see the reference's docstring for why)."""
    h, w = excess.shape
    px = torch.round(xy[:, 0]).to(torch.int64).clamp(1, w - 2)
    py = torch.round(xy[:, 1]).to(torch.int64).clamp(1, h - 2)
    s_c = excess[py, px]

    def parabola(lo, c, hi):
        denom = lo - 2.0 * c + hi
        ok = denom < -1e-9                # strictly concave around the peak
        off = torch.where(ok, 0.5 * (lo - hi) / torch.where(ok, denom, -1.0), 0.0)
        return off.clamp(-0.5, 0.5)

    ox = parabola(excess[py, px - 1], s_c, excess[py, px + 1])
    oy = parabola(excess[py - 1, px], s_c, excess[py + 1, px])
    cand = torch.stack([px.to(torch.float32) + ox, py.to(torch.float32) + oy], dim=-1)
    return torch.where(valid[:, None], cand, xy)
