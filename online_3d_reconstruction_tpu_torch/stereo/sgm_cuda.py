"""The SGM stage's hand-written CUDA kernels, with their plain PyTorch
versions and launch counters.

K4 ``census_cost``: census codes of both images and the uint8 Hamming cost
volume in one launch (csrc/census_cost.cu), in place of the plain chain
``census.census_transform`` + ``census.cost_volume`` (no TPU kernel: the
reference leaves both to XLA).

K1 ``aggregate``: SGM path aggregation over all directions in one launch,
plus one that widens or rounds its sums (csrc/sgm_aggregate.cu), replacing
the TPU kernel ``sgm_pallas._multi_kernel``; in float32 storage, or in
bfloat16 or float16 with that kernel's four roundings (its default is
``cost_dtype="bfloat16"``).
K2 ``run_total``: speckle-filter run totals (csrc/speckle_run_total.cu),
replacing the TPU kernel ``sgm_pallas._run_total_kernel``.
K3 ``scan_pair``: the single-direction forward + backward scan pair, both
chains in one launch (csrc/sgm_scan_pair.cu), replacing the TPU kernels
``sgm_pallas._fwd_kernel`` and ``sgm_pallas._bwd_kernel``; ``scan_launch``
runs one of the two passes alone. The profilers reach it
(``tools.profile_stages``, ``tools.profile_sgm``).

Device policy: a wrapper given CPU tensors runs the plain version (the CPU
tests' path); given CUDA tensors it launches the kernel, or raises. There is
no fallback from the card to the plain version. Each launch is counted in
``cuda_build.launch_counts``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.stereo.census import census_transform, cost_volume
from online_3d_reconstruction_tpu_torch.utils import cuda_build
from online_3d_reconstruction_tpu_torch.utils.cuda_build import (
    check,
    launch,
    load_kernels,
    on_card,
)

_BIG = 1e9

# scan directions (dy, dx) in the order 2 / 4 / 8 paths add them
DIRECTIONS = ((0, 1), (0, -1), (1, 0), (-1, 0),
              (1, 1), (-1, -1), (1, -1), (-1, 1))


def _check_paths(num_paths: int) -> None:
    if num_paths not in (2, 4, 8):
        raise ValueError(f"num_paths must be 2, 4, or 8, got {num_paths}")


# ---------------------------------------------------------------------------
# K4: census transform and cost volume
# ---------------------------------------------------------------------------

_CENSUS_MAX_D = 256


def census_cost_plain(left: torch.Tensor, right: torch.Tensor,
                      window: Tuple[int, int] = (5, 5), max_disparity: int = 64) -> torch.Tensor:
    """Plain PyTorch K4: ``census_transform`` of both images, ``cost_volume``
    and the cast to uint8 (census costs are <= 32, so uint8 is exact)."""
    return cost_volume(census_transform(left, window), census_transform(right, window),
                       max_disparity).to(torch.uint8)


def census_cost(left: torch.Tensor, right: torch.Tensor, window: Tuple[int, int] = (5, 5),
                max_disparity: int = 64) -> torch.Tensor:
    """Rectified (H, W) images -> the (H, W, D) uint8 Hamming cost volume
    of their census codes, the volume K1 reads: cost[y, x, d] =
    popcount(L[y, x] ^ R[y, x - d]), ``census.OUT_OF_IMAGE_COST`` where
    x - d < 0; the codes as ``census.census_transform`` makes them (an odd
    window of at most 32 bits, edge-replicated borders, compared in
    float32).

    On CUDA: K4, ONE launch that computes both images' codes on the chip
    and writes the volume once (D up to 256), bit-equal to
    ``census_cost_plain``; ``launch_counts["census_cost"]`` counts it. On
    the CPU: ``census_cost_plain``. Raises ValueError for a window or an
    image the census does not take, on either device.
    """
    wh, ww = window
    if wh * ww - 1 > 32:
        raise ValueError(f"census window {window} needs >32 bits")
    if wh % 2 == 0 or ww % 2 == 0 or min(wh, ww) < 1:
        raise ValueError("census window must be odd-sized")
    if left.dim() != 2 or right.shape != left.shape:
        raise ValueError(f"census takes two (H, W) images of one shape, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    if max_disparity < 1:
        raise ValueError(f"max_disparity must be >= 1, got {max_disparity}")
    if not on_card(left):
        return census_cost_plain(left, right, window, max_disparity)
    if right.device != left.device:
        raise ValueError(f"K4 takes both images on one device, got {left.device} "
                         f"and {right.device}")
    if max_disparity > _CENSUS_MAX_D:
        raise ValueError(f"K4 takes D up to {_CENSUS_MAX_D}, got {max_disparity}")
    left = left.to(torch.float32).contiguous()
    right = right.to(torch.float32).contiguous()
    h, w = left.shape
    cost = torch.empty((h, w, max_disparity), dtype=torch.uint8, device=left.device)
    lib = load_kernels()
    rc = launch(left.device, lib.o3r_census_cost, left.data_ptr(), right.data_ptr(),
                cost.data_ptr(), h, w, max_disparity, wh, ww)
    check(lib, rc, "census_cost kernel")
    cuda_build.launch_counts["census_cost"] += 1
    return cost


# ---------------------------------------------------------------------------
# K1: SGM path aggregation
# ---------------------------------------------------------------------------

def _sgm_step(carry: torch.Tensor, cost_slice: torch.Tensor, p1: float,
              p2: float) -> torch.Tensor:
    """One recurrence step over lines (L, D) (sgm._sgm_step)."""
    min_prev = carry.min(dim=-1, keepdim=True).values
    edge = torch.full_like(carry[:, :1], _BIG)
    d_minus = torch.cat([edge, carry[:, :-1]], dim=1) + p1
    d_plus = torch.cat([carry[:, 1:], edge], dim=1) + p1
    best = torch.minimum(torch.minimum(carry, min_prev + p2),
                         torch.minimum(d_minus, d_plus))
    return cost_slice + best - min_prev


def _scan_path(cost: torch.Tensor, p1: float, p2: float, reverse: bool,
               shift: int = 0) -> torch.Tensor:
    """Aggregate along axis 0 of (S, L, D); ``shift`` +-1 makes the carry's
    predecessor the neighbouring line, zero-filled at the edge (a diagonal
    starting fresh at the image border), flipped for the reverse pass."""
    eff = -shift if reverse else shift
    out = torch.empty_like(cost)
    carry = torch.zeros_like(cost[0])
    order = range(cost.shape[0] - 1, -1, -1) if reverse else range(cost.shape[0])
    zero = torch.zeros_like(carry[:1])
    for s in order:
        if eff > 0:
            carry = torch.cat([zero, carry[:-1]], dim=0)
        elif eff < 0:
            carry = torch.cat([carry[1:], zero], dim=0)
        carry = _sgm_step(carry, cost[s], p1, p2)
        out[s] = carry
    return out


# K1's half-precision storage formats, as the kernels number them
HALF_FORMATS = {torch.bfloat16: 0, torch.float16: 1}


def _check_storage(dtype: torch.dtype) -> None:
    if dtype != torch.float32 and dtype not in HALF_FORMATS:
        raise ValueError(f"K1 stores float32, bfloat16 or float16, got {dtype}")


def aggregate_plain(cost: torch.Tensor, p1: float, p2: float, num_paths: int = 4,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch K1: cost (H, W, D) -> (H, W, D) in the storage ``dtype``,
    the sum over 2 (horizontal), 4 (+ vertical) or 8 (+ both diagonals)
    scan paths. A Python loop over scan steps.

    float32 (sgm.aggregate_scan): the exact sum, directions added in pairs.
    bfloat16 or float16 (sgm_pallas.aggregate_fused at that storage dtype):
    the carries stay f32 and the total is rounded (r) where the TPU kernel
    stores it, four times, ``r(r(r(r(h_fwd) + h_bwd) + tri_fwd) + tri_bwd)``,
    each group added to the f32 value of the rounded total in that kernel's
    order (vertical, then the +1 and the -1 diagonal). With 4 paths a tri
    group is its vertical direction alone; with 2 paths the total is
    ``r(r(h_fwd) + h_bwd)``."""
    _check_paths(num_paths)
    _check_storage(dtype)
    cost = cost.to(torch.float32)
    cost_t = cost.transpose(0, 1)
    if dtype in HALF_FORMATS:
        total = _scan_path(cost_t, p1, p2, False).transpose(0, 1).to(dtype)
        total = (total.to(torch.float32)
                 + _scan_path(cost_t, p1, p2, True).transpose(0, 1)).to(dtype)
        if num_paths >= 4:
            shifts = (0, 1, -1) if num_paths == 8 else (0,)
            for reverse in (False, True):
                acc = total.to(torch.float32)
                for shift in shifts:
                    acc = acc + _scan_path(cost, p1, p2, reverse, shift=shift)
                total = acc.to(dtype)
        return total.contiguous()
    total = (_scan_path(cost_t, p1, p2, False)
             + _scan_path(cost_t, p1, p2, True)).transpose(0, 1)
    if num_paths >= 4:
        total = (total + _scan_path(cost, p1, p2, False)
                 + _scan_path(cost, p1, p2, True))
    if num_paths == 8:
        for shift in (1, -1):
            total = (total + _scan_path(cost, p1, p2, False, shift=shift)
                     + _scan_path(cost, p1, p2, True, shift=shift))
    return total.contiguous()


def line_table(h: int, w: int, num_paths: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every scan line of an (h, w) frame for the first ``num_paths``
    ``DIRECTIONS``: an (N, 4) int32 array of (first pixel, pixel step,
    length, direction index), pixels counted row-major, and the (num_paths
    + 1,) offsets of each direction's rows. Rows and columns are one line
    each; a diagonal family has w lines entering on a row and h - 1 on a
    column. Within a direction the lines come longest first (ties in the
    order they enter), so neighbouring lines, which share a warp, have near
    equal lengths."""
    _check_paths(num_paths)
    tables = []
    for index, (dy, dx) in enumerate(DIRECTIONS[:num_paths]):
        if dy == 0:
            y0 = np.arange(h)
            x0 = np.full(h, 0 if dx > 0 else w - 1)
            length = np.full(h, w)
        elif dx == 0:
            x0 = np.arange(w)
            y0 = np.full(w, 0 if dy > 0 else h - 1)
            length = np.full(w, h)
        else:
            k = np.arange(1, h)      # lines entering on the side column
            y0 = np.concatenate([np.full(w, 0 if dy > 0 else h - 1),
                                 k if dy > 0 else h - 1 - k])
            x0 = np.concatenate([np.arange(w), np.full(h - 1, 0 if dx > 0 else w - 1)])
            rows_left = h - y0 if dy > 0 else y0 + 1
            cols_left = w - x0 if dx > 0 else x0 + 1
            length = np.minimum(rows_left, cols_left)
        table = np.stack([y0 * w + x0, np.full_like(y0, dy * w + dx), length,
                          np.full_like(y0, index)], axis=1)
        tables.append(table[np.argsort(-length, kind="stable")])
    offsets = np.cumsum([0] + [len(t) for t in tables])
    return np.concatenate(tables).astype(np.int32), offsets.astype(np.int64)


def longest_first(table: np.ndarray) -> np.ndarray:
    """The lines of all directions in one order, longest first (stable): the
    order in which the one-launch kernel hands them to its warps."""
    return table[np.argsort(-table[:, 2], kind="stable")]


def half_table(h: int, w: int, num_paths: int) -> Tuple[np.ndarray, int]:
    """The lines of K1's half form in the order its launch hands them to its
    warps: first the row pairs, the forward then the backward row of each
    image row (neighbours, so that the two chains of a row share a warp, or
    the two warps of a block), filled with length-0 lines up to a multiple
    of 32 lines (so that no block mixes row pairs and other lines); then the
    vertical and diagonal lines, longest first. Returns the (N, 4) int32
    table (as ``line_table``'s) and the row pairs' share of it."""
    table, offsets = line_table(h, w, num_paths)
    pairs = np.stack([table[offsets[0]:offsets[1]], table[offsets[1]:offsets[2]]], axis=1)
    fill = np.zeros(((-2 * h) % 32, 4), np.int32)
    rows = np.concatenate([pairs.reshape(-1, 4), fill])
    return np.concatenate([rows, longest_first(table[offsets[2]:])]), len(rows)


# device copies of the line tables, made once per (h, w, paths, device):
# lines longest first, lines by direction, direction offsets, and the half
# form's lines with the count of its row-pair lines
_line_tables: Dict[tuple, tuple] = {}


def _device_tables(h: int, w: int, num_paths: int, device: torch.device):
    key = (h, w, num_paths, device)
    if key not in _line_tables:
        table, offsets = line_table(h, w, num_paths)
        half, pair_lines = half_table(h, w, num_paths)
        _line_tables[key] = (torch.from_numpy(longest_first(table)).to(device),
                             torch.from_numpy(table).to(device), offsets,
                             torch.from_numpy(half).to(device), pair_lines)
    return _line_tables[key]


def sums_fit_16_bits(p1: float, p2: float, num_paths: int) -> bool:
    """Whether the sum over directions can be formed in any order in 16-bit
    integers: with uint8 costs and non-negative integer penalties every path
    value is an integer <= 255 + P2, so every partial sum is an integer, and
    below 2^16 where ``num_paths * (255 + P2)`` is."""
    return (float(p1).is_integer() and float(p2).is_integer()
            and p1 >= 0 and p2 >= 0 and num_paths * (255.0 + p2) < 2.0 ** 16)


def groups_fit_32_bits(p1: float, p2: float, num_paths: int) -> bool:
    """Whether K1's half form takes these penalties: integer P1, P2 >= 0, so
    that with uint8 costs every path value is an integer in [0, m], m = 255
    + P2, and the sums its accumulator holds as 16-bit integers in 32 bits a
    cell, g2 and g3 (up to 3 m with 8 paths, m with 4), and the row pairs'
    stash g1 (m) are below 2^16: P2 <= 21590 with 8 paths, 65280 with 4
    and 2."""
    if not (float(p1).is_integer() and float(p2).is_integer() and p1 >= 0 and p2 >= 0):
        return False
    return (3 if num_paths == 8 else 1) * (255.0 + p2) < 2.0 ** 16


# the half forms' groups of directions (DIRECTIONS indices), in the order
# the TPU kernel rounds their partial totals: the horizontal forward and
# backward directions, then the vertical and diagonal forward and backward
HALF_GROUPS = ((0,), (1,), (2, 4, 6), (3, 5, 7))


def aggregate(cost: torch.Tensor, p1: float, p2: float, num_paths: int = 4,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SGM path aggregation: cost (H, W, D) -> (H, W, D) sum over
    ``num_paths`` directions, in the storage ``dtype``: float32, the exact
    sum, or bfloat16 or float16, rounded at the TPU kernel's four points
    (see ``aggregate_plain``).

    On CUDA: K1. It takes uint8 costs (census costs are <= 32) and D a
    multiple of 8 up to 256. float32 with integer penalties that
    ``sums_fit_16_bits`` (the defaults): two launches, ONE over the scan
    lines of all directions, which add into a zeroed uint16 accumulator by
    64-bit integer reductions in no fixed order (every partial sum is an
    exact integer), then one that widens it to float32. The half form with
    integer penalties that ``groups_fit_32_bits`` (the defaults): ONE launch
    in which the forward and backward chains of each row meet in the middle
    and store the first two roundings in the total while the other lines
    add their group sums into 32 bits a cell, then one that applies the last
    two roundings; with 2 paths the first launch stores the total itself. Both are bit-equal to ``aggregate_plain`` and the same from run
    to run. With any other penalties an unordered sum would round
    differently from run to run, so the kernel is launched once per
    direction over that direction's lines, adding into an f32 total: a cell
    then receives one reduction per launch and the stream orders the
    launches, so the result is the same from run to run. float32 adds the
    directions in ``DIRECTIONS`` order and is within f32 rounding of
    ``aggregate_plain`` (which sums them in pairs); the half form adds them
    group by group in the TPU kernel's order, with a rounding launch after
    each group, and is bit-equal to ``aggregate_plain``.
    ``launch_counts["sgm_path"]`` counts the launches of all forms: 2, or
    ``num_paths`` (float32), or 2 (1 with 2 paths), or ``num_paths`` + 2 or
    + 4 (half); ``launch_counts["sgm_path_half"]`` those of the half form
    alone. On the CPU: ``aggregate_plain``.
    """
    _check_paths(num_paths)
    _check_storage(dtype)
    if not on_card(cost):
        return aggregate_plain(cost, p1, p2, num_paths, dtype)
    if cost.dtype != torch.uint8 or cost.dim() != 3:
        raise ValueError(f"K1 takes a (H, W, D) uint8 cost volume, got "
                         f"{tuple(cost.shape)} {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("K1 takes a contiguous cost volume")
    h, w, d = cost.shape
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"K1 takes D a multiple of 8 in [8, 256], got {d}")
    if h * w * d >= 2 ** 31:
        raise ValueError(f"K1 takes fewer than 2^31 cells, got {(h, w, d)}")
    return k1_launches(load_kernels(), functools.partial(launch, cost.device), cost,
                       p1, p2, num_paths, dtype,
                       _device_tables(h, w, num_paths, cost.device))


def k1_launches(lib, launch, cost: torch.Tensor, p1: float, p2: float, num_paths: int,
                dtype: torch.dtype, tables) -> torch.Tensor:
    """K1's launches for ``aggregate`` (checked arguments): ``launch(entry,
    *args)`` calls an entry point of ``lib`` on the stream and returns its
    error code; ``tables`` are ``_device_tables``' on the cost's device.
    Allocates the accumulator and the total, counts each launch."""
    h, w, d = cost.shape
    n = h * w * d
    by_length, by_direction, offsets, half_lines, pair_lines = tables
    half = dtype in HALF_FORMATS
    fmt = HALF_FORMATS.get(dtype)

    def run(entry, what, *args):
        check(lib, launch(getattr(lib, entry), *args), what)
        cuda_build.launch_counts["sgm_path"] += 1
        if half:
            cuda_build.launch_counts["sgm_path_half"] += 1

    def lines_launch(acc, lines, mode):
        run("o3r_sgm_aggregate", "sgm_aggregate kernel", cost.data_ptr(), acc.data_ptr(),
            lines.data_ptr(), len(lines), d, float(p1), float(p2), mode)

    def direction(k):
        return by_direction[offsets[k]:offsets[k + 1]]

    total = torch.empty((h, w, d), dtype=dtype, device=cost.device)
    if half and groups_fit_32_bits(p1, p2, num_paths):
        # the group sums g2, g3 of the vertical and diagonal lines (none
        # with 2 paths, where the row pairs store the total itself)
        acc = None if num_paths == 2 else torch.zeros(
            2 * n, dtype=torch.int16, device=cost.device)
        run("o3r_sgm_aggregate_half", "sgm_aggregate_half kernel", cost.data_ptr(),
            total.data_ptr(), None if acc is None else acc.data_ptr(), half_lines.data_ptr(),
            len(half_lines), pair_lines, d, float(p1), float(p2), fmt)
        if acc is not None:
            run("o3r_sgm_finish_half", "sgm_finish_half kernel", acc.data_ptr(),
                total.data_ptr(), n, d, fmt)
    elif half:
        acc = torch.zeros((h, w, d), dtype=torch.float32, device=cost.device)
        groups = [[k for k in group if k < num_paths] for group in HALF_GROUPS]
        groups = [group for group in groups if group]
        for i, group in enumerate(groups):
            for k in group:
                lines_launch(acc, direction(k), 0)
            last = i == len(groups) - 1
            run("o3r_sgm_round_half", "sgm_round_half kernel", acc.data_ptr(),
                (total if last else acc).data_ptr(), n, int(last), fmt)
    elif sums_fit_16_bits(p1, p2, num_paths):
        acc = torch.zeros((h, w, d), dtype=torch.int16, device=cost.device)
        lines_launch(acc, by_length, 1)
        run("o3r_sgm_unpack16", "sgm_unpack16 kernel", acc.data_ptr(), total.data_ptr(), n)
    else:
        total.zero_()
        for k in range(num_paths):
            lines_launch(total, direction(k), 0)
    return total


# ---------------------------------------------------------------------------
# K2: speckle run totals
# ---------------------------------------------------------------------------

def run_total_plain(v: torch.Tensor, start: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Plain PyTorch K2 (sgm_pallas._run_total): per pixel, the sum of ``v``
    over its maximal run along ``axis``; a run starts where ``start`` > 0.5
    and at index 0. Runs get dense ids from a cumulative sum of the start
    flags, are summed with ``index_add_`` and read back per pixel. Exact
    for integer-valued v whose run sums stay below 2^24, as on the path."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    vt = (v if axis == 1 else v.t()).to(torch.float32)
    st = (start if axis == 1 else start.t()) > 0.5
    st = st.clone()
    st[:, 0] = True
    seg = torch.cumsum(st.reshape(-1).to(torch.int64), 0) - 1
    sums = torch.zeros(int(vt.numel()), dtype=torch.float32, device=v.device)
    sums.index_add_(0, seg, vt.reshape(-1))
    out = sums[seg].reshape(vt.shape)
    return (out if axis == 1 else out.t()).contiguous()


_RUN_TOTAL_MAX_LINE = 16384   # 32 tiles of 512 pixels a warp (the kernel's limit)


def run_total(v: torch.Tensor, start: torch.Tensor, axis: int) -> torch.Tensor:
    """Run totals of v (H, W) float32 along ``axis`` (0: down columns, 1:
    along rows), runs split at ``start`` (H, W) float32 0/1 flags.

    On CUDA: K2, one launch that reads ``v`` and ``start`` once and writes
    the result once (lines of up to 16384 pixels; up to 512 in one pass).
    On the CPU: ``run_total_plain``.
    """
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if not on_card(v):
        return run_total_plain(v, start, axis)
    if (v.dtype != torch.float32 or start.dtype != torch.float32 or v.dim() != 2
            or start.shape != v.shape or start.device != v.device
            or not (v.is_contiguous() and start.is_contiguous())):
        raise ValueError(
            f"K2 takes contiguous (H, W) float32 v and start of one shape on one "
            f"device, got {tuple(v.shape)} {v.dtype} on {v.device} and "
            f"{tuple(start.shape)} {start.dtype} on {start.device}")
    h, w = v.shape
    if (w if axis == 1 else h) > _RUN_TOTAL_MAX_LINE:
        raise ValueError(f"K2 takes lines of at most {_RUN_TOTAL_MAX_LINE} pixels, "
                         f"got {(h, w)} along axis {axis}")
    lib = load_kernels()
    out = torch.empty_like(v)
    rc = launch(v.device, lib.o3r_run_total, v.data_ptr(), start.data_ptr(),
                out.data_ptr(), h, w, axis)
    check(lib, rc, "run_total kernel")
    cuda_build.launch_counts["run_total"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: single-direction scan pair
# ---------------------------------------------------------------------------

_SCAN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def scan_fwd_plain(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Plain PyTorch K3 forward pass (sgm_pallas._fwd_kernel): the
    aggregation down axis 0 of cost (S, L, D) from a zero carry, with the
    carry in f32 and the result stored in the storage dtype of ``cost``."""
    return _scan_path(cost.to(torch.float32), p1, p2, reverse=False).to(cost.dtype)


def scan_bwd_plain(cost: torch.Tensor, acc: torch.Tensor, p1: float,
                   p2: float) -> torch.Tensor:
    """Plain PyTorch K3 backward pass (sgm_pallas._bwd_kernel): the
    aggregation up axis 0 from a zero carry, added in f32 to ``acc`` (the
    forward result) and stored in the storage dtype, in place into ``acc``,
    which is returned."""
    back = _scan_path(cost.to(torch.float32), p1, p2, reverse=True)
    return acc.copy_(acc.to(torch.float32) + back)


def scan_pair_plain(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Plain PyTorch K3 (sgm_pallas.scan_pair): the forward plus the
    backward aggregation along axis 0 of cost (S, L, D), in the storage
    dtype of ``cost``, rounded where the TPU kernels round (the forward
    result, then the sum)."""
    return scan_bwd_plain(cost, scan_fwd_plain(cost, p1, p2), p1, p2)


def _check_scan_volume(cost: torch.Tensor) -> None:
    if cost.dtype not in _SCAN_DTYPES or cost.dim() != 3:
        raise ValueError(f"K3 takes a (S, L, D) float32 or bfloat16 volume, "
                         f"got {tuple(cost.shape)} {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("K3 takes a contiguous volume")
    s, l, d = cost.shape
    if s < 1 or l < 1 or not 1 <= d <= 256:
        raise ValueError(f"K3 takes S, L >= 1 and D in [1, 256], got {(s, l, d)}")


def scan_launch(name: str, cost: torch.Tensor, out: torch.Tensor, p1: float,
                p2: float) -> None:
    """One K3 pass alone (``name`` "scan_fwd" or "scan_bwd"): the forward
    pass writes ``out``, the backward pass adds into it in place. On CUDA
    tensors it launches that pass's kernel; on CPU tensors it runs
    ``scan_fwd_plain`` / ``scan_bwd_plain``."""
    if name not in ("scan_fwd", "scan_bwd"):
        raise ValueError(f"no K3 pass named {name!r}")
    if not on_card(cost):
        if name == "scan_fwd":
            out.copy_(scan_fwd_plain(cost, p1, p2))
        else:
            scan_bwd_plain(cost, out, p1, p2)
        return
    _check_scan_volume(cost)
    if (out.shape != cost.shape or out.dtype != cost.dtype or out.device != cost.device
            or not out.is_contiguous()):
        raise ValueError("K3 takes an output of the cost's shape, dtype and device")
    lib = load_kernels()
    s, l, d = cost.shape
    rc = launch(cost.device, getattr(lib, "o3r_" + name), cost.data_ptr(),
                out.data_ptr(), s, l, d, _SCAN_DTYPES[cost.dtype], float(p1), float(p2))
    check(lib, rc, f"{name} kernel")
    cuda_build.launch_counts[name] += 1


def scan_pair(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Sum of the forward and backward SGM aggregation along axis 0 of
    (S, L, D); the output dtype is the input's (float32 or bfloat16).

    On CUDA: K3, ONE launch in which the forward and the backward chain of
    every line run at once and meet in the middle: the first to reach a cell
    stashes its value in f32 (the forward result rounded to the storage
    dtype, the backward carry as it is), the second adds its own and stores
    the rounded sum. float32 stashes in the output itself; bfloat16 in an
    f32 scratch volume allocated here. It takes a contiguous volume with D
    in [1, 256], and is bit-equal to ``scan_pair_plain``.
    ``launch_counts["scan_pair"]`` counts the launch. On the CPU:
    ``scan_pair_plain``.
    """
    if not on_card(cost):
        return scan_pair_plain(cost, p1, p2)
    _check_scan_volume(cost)
    s, l, d = cost.shape
    out = torch.empty_like(cost)
    stash = out if cost.dtype == torch.float32 else torch.empty(
        cost.shape, dtype=torch.float32, device=cost.device)
    lib = load_kernels()
    rc = launch(cost.device, lib.o3r_scan_pair, cost.data_ptr(), out.data_ptr(),
                stash.data_ptr(), s, l, d, _SCAN_DTYPES[cost.dtype], float(p1), float(p2))
    check(lib, rc, "scan_pair kernel")
    cuda_build.launch_counts["scan_pair"] += 1
    return out
