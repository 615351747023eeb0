"""Oriented BRIEF descriptors (port of features/brief.py).

Patches are gathered directly and the steered pattern is sampled with a
plain bilinear gather: the reference's one-hot and hat-weight matmuls stand
in for gathers the TPU serializes. Descriptors are (K, bits / 32) int64
words holding 32 bits each (LSB first), the reference's uint32 words.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import FeatureConfig
from .fast import detect_keypoints


class Keypoints(NamedTuple):
    """Static-capacity keypoint set with packed binary descriptors."""

    xy: torch.Tensor           # (K, 2) float32 pixel coords [x, y]
    score: torch.Tensor        # (K,) float32 detection score
    angle: torch.Tensor        # (K,) float32 orientation (radians)
    descriptors: torch.Tensor  # (K, W) int64 words of 32 descriptor bits
    valid: torch.Tensor        # (K,) bool
    octave: torch.Tensor       # (K,) int64 pyramid level (0 = full resolution)


def brief_pattern(bits: int, patch_size: int, seed: int) -> np.ndarray:
    """(bits, 4) float32 point-pair offsets (y1, x1, y2, x2), Gaussian BRIEF
    sampling clipped inside the patch. The same numpy draw as the reference
    (whose module cannot be imported without jax)."""
    rng = np.random.default_rng(seed)
    lim = patch_size // 2 - 2
    pts = rng.normal(0.0, patch_size / 5.0, size=(bits, 4))
    return np.clip(pts, -lim, lim).astype(np.float32)


# the pattern on each device, made once per (bits, patch, seed, device): a
# fresh upload every frame would make the host wait for the card
_PATTERNS: Dict[tuple, torch.Tensor] = {}


def _device_pattern(config: FeatureConfig, device: torch.device) -> torch.Tensor:
    key = (config.descriptor_bits, config.patch_size, config.seed, device)
    if key not in _PATTERNS:
        _PATTERNS[key] = torch.from_numpy(
            brief_pattern(config.descriptor_bits, config.patch_size, config.seed)).to(device)
    return _PATTERNS[key]


def _gaussian_blur(image: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur, edge-replicated."""
    k = (np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0).tolist()
    h, w = image.shape
    pad = F.pad(image[None, None], (0, 0, 2, 2), mode="replicate")[0, 0]
    rows = k[0] * pad[0:h]
    for i in range(1, 5):
        rows = rows + k[i] * pad[i:i + h]
    pad = F.pad(rows[None, None], (2, 2, 0, 0), mode="replicate")[0, 0]
    out = k[0] * pad[:, 0:w]
    for i in range(1, 5):
        out = out + k[i] * pad[:, i:i + w]
    return out


def _patch_centers(xy: torch.Tensor, half: int, h: int, w: int):
    cx = torch.round(xy[:, 0]).to(torch.int64).clamp(half, w - 1 - half)
    cy = torch.round(xy[:, 1]).to(torch.int64).clamp(half, h - 1 - half)
    return cx, cy


def _extract_patches(image: torch.Tensor, xy: torch.Tensor, patch: int) -> torch.Tensor:
    """(K, P, P) patches centered on the rounded keypoint coords."""
    half = patch // 2
    h, w = image.shape
    cx, cy = _patch_centers(xy, half, h, w)
    off = torch.arange(-half, half + 1, device=image.device)
    return image[(cy[:, None] + off)[:, :, None], (cx[:, None] + off)[:, None, :]]


def _orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10) over a circular mask."""
    p = patches.shape[1]
    half = p // 2
    coords = torch.arange(p, dtype=torch.float32, device=patches.device) - half
    yy = coords[:, None]
    xx = coords[None, :]
    masked = torch.where(((yy * yy + xx * xx) <= half * half)[None], patches, 0.0)
    m10 = (masked * xx[None]).sum(dim=(1, 2))
    m01 = (masked * yy[None]).sum(dim=(1, 2))
    return torch.atan2(m01, m10)


def _sample_bilinear(patches: torch.Tensor, py: torch.Tensor,
                     px: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (K, P, P) patches at (K, B) float coords, clamped
    to the patch; the weights are the reference's hat functions
    max(0, 1 - |c - p|) at the two grid lines around each coordinate."""
    k, p, _ = patches.shape
    py = py.clamp(0.0, p - 1.0)
    px = px.clamp(0.0, p - 1.0)
    y0 = torch.floor(py).clamp(max=p - 2)
    x0 = torch.floor(px).clamp(max=p - 2)
    wy0 = torch.clamp(1.0 - (y0 - py).abs(), min=0.0)
    wy1 = torch.clamp(1.0 - (y0 + 1.0 - py).abs(), min=0.0)
    wx0 = torch.clamp(1.0 - (x0 - px).abs(), min=0.0)
    wx1 = torch.clamp(1.0 - (x0 + 1.0 - px).abs(), min=0.0)
    flat = patches.reshape(k, p * p)
    yi = y0.to(torch.int64)
    xi = x0.to(torch.int64)

    def at(dy, dx):
        return torch.gather(flat, 1, (yi + dy) * p + xi + dx)

    row0 = at(0, 0) * wy0 + at(1, 0) * wy1     # column x0
    row1 = at(0, 1) * wy0 + at(1, 1) * wy1     # column x0 + 1
    return row0 * wx0 + row1 * wx1


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, B) bool -> (K, B / 32) int64 words, LSB first."""
    k, b = bits.shape
    words = bits.reshape(k, b // 32, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    return (words << shifts).sum(dim=-1)


def describe_keypoints(image: torch.Tensor, xy: torch.Tensor, score: torch.Tensor,
                       valid: torch.Tensor, config: FeatureConfig) -> Keypoints:
    """Orientations + steered BRIEF descriptors for detected corners.

    Patches sit on the rounded keypoint; the subpixel residual shifts the
    sampling pattern, so every bit compares intensities around the
    keypoint's true position.
    """
    if config.descriptor_bits % 32:
        raise ValueError("descriptor_bits must be a multiple of 32")
    dev = image.device
    pattern = _device_pattern(config, dev)
    blurred = _gaussian_blur(image.to(torch.float32))
    patches = _extract_patches(blurred, xy, config.patch_size)
    angle = _orientation(patches)

    half = config.patch_size // 2
    h, w = image.shape
    pcx, pcy = _patch_centers(xy, half, h, w)
    res_x = (xy[:, 0] - pcx.to(torch.float32))[:, None]
    res_y = (xy[:, 1] - pcy.to(torch.float32))[:, None]
    cos_t = torch.cos(angle)[:, None]
    sin_t = torch.sin(angle)[:, None]
    y1, x1, y2, x2 = pattern[:, 0], pattern[:, 1], pattern[:, 2], pattern[:, 3]

    def rotate(y, x):
        ry = x[None, :] * sin_t + y[None, :] * cos_t
        rx = x[None, :] * cos_t - y[None, :] * sin_t
        return ry + half + res_y, rx + half + res_x

    i1 = _sample_bilinear(patches, *rotate(y1, x1))
    i2 = _sample_bilinear(patches, *rotate(y2, x2))
    desc = torch.where(valid[:, None], _pack_bits(i1 < i2), 0)
    return Keypoints(xy=xy, score=score, angle=angle, descriptors=desc,
                     valid=valid,
                     octave=torch.zeros(xy.shape[0], dtype=torch.int64, device=dev))


def _downsample2(image: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling (an odd trailing row or column is dropped): each
    row pair is summed first, then the two sums, the reference's order, so
    every level is bit-equal to its."""
    h, w = image.shape
    x = image[:2 * (h // 2), :2 * (w // 2)]
    return ((x[0::2, 0::2] + x[0::2, 1::2]) + (x[1::2, 0::2] + x[1::2, 1::2])) / 4.0


def _level_budgets(total: int, levels: int) -> list:
    """Per-level keypoint caps, halving per level (ORB-style), summing to total."""
    raw = [0.5 ** level for level in range(levels)]
    norm = sum(raw)
    caps = [max(1, int(round(total * r / norm))) for r in raw]
    caps[0] += total - sum(caps)
    return caps


def detect_and_describe(image: torch.Tensor, config: FeatureConfig) -> Keypoints:
    """FAST detection + oriented BRIEF on an image pyramid: each 2x-downsampled
    level (as many of ``num_levels`` as stay large enough for the patch) gets
    a halving share of ``max_keypoints``, is detected and described at its
    own scale, and its coordinates are mapped back to full resolution."""
    levels = 1
    h, w = image.shape
    min_side = 2 * (config.patch_size + 2 * config.nms_radius + 8)
    while levels < config.num_levels and min(h, w) // (2 ** levels) >= min_side:
        levels += 1
    caps = _level_budgets(config.max_keypoints, levels)
    parts = []
    img_l = image
    for level in range(levels):
        if level:
            img_l = _downsample2(img_l)
        xy, score, valid = detect_keypoints(
            img_l,
            max_keypoints=caps[level],
            threshold=config.fast_threshold / 255.0,
            arc=config.fast_arc,
            nms_radius=config.nms_radius,
            border=config.border,
            grid_tiles=config.grid_tiles,
            subpixel=config.subpixel,
        )
        kp = describe_keypoints(img_l, xy, score, valid, config)
        parts.append(kp._replace(xy=kp.xy * float(2 ** level),
                                 octave=torch.full_like(kp.octave, level)))
    if len(parts) == 1:
        return parts[0]
    return Keypoints(*(torch.cat(fields) for fields in zip(*parts)))
