"""Census transform + Hamming cost volume (port of stereo/census.py).

torch has no population count and leaves several uint32 operations
unimplemented on the CPU, so census codes are int64 holding at most 32 bits
and the Hamming weight is a SWAR bit count. The cost volume keeps the
(H, W, D) layout; the TPU's (H, D, W) ``cost_volume_dl`` is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# Hamming cost of a hypothesis whose right pixel lies left of the image
OUT_OF_IMAGE_COST = 32


def census_transform(image: torch.Tensor,
                     window: Tuple[int, int] = (5, 5)) -> torch.Tensor:
    """(H, W) grayscale -> (H, W) int64 census codes.

    One bit per non-center neighbour in the window, row-major: bit = 1 iff
    neighbour < center. Edge-replicated borders. At most 32 bits.
    """
    wh, ww = window
    if (wh * ww - 1) > 32:
        raise ValueError(f"census window {window} needs >32 bits")
    if wh % 2 == 0 or ww % 2 == 0:
        raise ValueError("census window must be odd-sized")
    ry, rx = wh // 2, ww // 2
    img = image.to(torch.float32)
    h, w = img.shape
    padded = F.pad(img[None, None], (rx, rx, ry, ry), mode="replicate")[0, 0]
    code = torch.zeros((h, w), dtype=torch.int64, device=img.device)
    bit = 0
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = padded[dy + ry:dy + ry + h, dx + rx:dx + rx + w]
            code |= (neighbor < img).to(torch.int64) << bit
            bit += 1
    return code


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits of each int64 element holding a value < 2^32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def cost_volume(census_left: torch.Tensor, census_right: torch.Tensor,
                max_disparity: int) -> torch.Tensor:
    """cost[y, x, d] = popcount(L[y, x] ^ R[y, x - d]) as (H, W, D) int32;
    hypotheses with x - d < 0 cost ``OUT_OF_IMAGE_COST``."""
    h, w = census_left.shape
    d = max_disparity
    dev = census_left.device
    padded_r = torch.cat(
        [torch.zeros((h, d), dtype=census_right.dtype, device=dev),
         census_right], dim=1)                                   # (H, W + D)
    x = torch.arange(w, device=dev)[:, None]
    disp = torch.arange(d, device=dev)[None, :]
    shifted_r = padded_r[:, x - disp + d]                         # (H, W, D)
    cost = popcount32(census_left[:, :, None] ^ shifted_r).to(torch.int32)
    oob = (x - disp) < 0
    return cost.masked_fill(oob[None], OUT_OF_IMAGE_COST)
