"""The yardstick of the kernels' roofline shares: the published peaks of
one NVIDIA H100 SXM (data sheet, dense rates, 700 W) and the work models of
the two SGM kernels, frozen here (from the port's ``utils/roofline.py``
and its bench's byte count) so that a change to the program cannot move
them. A bound is the larger of the compulsory bytes at the memory
bandwidth and the operations at the float32 vector rate."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def sgm_aggregation_bound_s(h: int, w: int, d: int, num_paths: int,
                            storage_bytes: int) -> float:
    """One SGM path aggregation of an (h, w, d) volume: the uint8 costs read
    once and the total written once in its storage; ~11 vector operations
    a cell and direction (2 shifted adds, 5 mins, a subtraction, an
    addition, the carry, and the D-wide minimum at ~1 a cell)."""
    cells = h * w * d
    return bound_s(cells * (1 + storage_bytes), 11.0 * num_paths * cells)


def speckle_run_totals_bound_s(h: int, w: int) -> float:
    """The speckle filter's four run totals of (h, w) float32 maps: each
    reads a value and a start flag a pixel and writes the total."""
    return bound_s(4 * 12.0 * h * w, 4 * 3.0 * h * w)
