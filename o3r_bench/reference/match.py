"""Brute-force Hamming descriptor matching (port of features/match.py).

For bipolar vectors a, b in {-1, +1}^B, Hamming(a, b) = (B - a.b) / 2, so
the full distance matrix is one f32 matrix product; its entries are
integers <= B, exact in f32 (TF32 is off on CUDA). Ratio test and mutual
cross-check follow; ``argmin`` keeps the first index on ties, as the
reference's does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INF = 1e9


class Matches(NamedTuple):
    """Fixed-capacity match set: one slot per query keypoint."""

    index: torch.Tensor     # (K,) int64 matched train keypoint per query
    distance: torch.Tensor  # (K,) float32 Hamming distance
    valid: torch.Tensor     # (K,) bool passed ratio / threshold / cross checks


def _unpack_bipolar(descriptors: torch.Tensor) -> torch.Tensor:
    """(K, W) words of 32 bits -> (K, 32 W) float32 in {-1, +1}."""
    shifts = torch.arange(32, device=descriptors.device)
    bits = (descriptors[:, :, None] >> shifts) & 1
    return bits.reshape(descriptors.shape[0], -1).to(torch.float32) * 2.0 - 1.0


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   valid_a: torch.Tensor, valid_b: torch.Tensor) -> torch.Tensor:
    """(Ka, Kb) float32 Hamming distances; invalid rows/cols get 1e9."""
    bits = desc_a.shape[1] * 32
    dot = _unpack_bipolar(desc_a) @ _unpack_bipolar(desc_b).t()
    dist = 0.5 * (bits - dot)
    return torch.where(valid_a[:, None] & valid_b[None, :], dist, _INF)


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      max_hamming: int = 64, ratio: float = 0.9,
                      cross_check: bool = True) -> Matches:
    """Match every query (a) descriptor against all train (b) descriptors:
    best + masked second best (Lowe ratio), absolute threshold, optional
    mutual nearest-neighbour check."""
    dist = hamming_matrix(desc_a, desc_b, valid_a, valid_b)
    best_idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    second = torch.where(cols[None, :] == best_idx[:, None], _INF, dist).amin(dim=1)
    ok = valid_a & (best <= max_hamming) & (best < ratio * second)
    if cross_check:
        back = torch.argmin(dist, dim=0)
        ok = ok & (back[best_idx] == torch.arange(dist.shape[0], device=dist.device))
    return Matches(index=best_idx, distance=best, valid=ok)
