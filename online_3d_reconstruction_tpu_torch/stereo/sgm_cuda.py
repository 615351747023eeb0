"""The SGM stage's hand-written CUDA kernels, with their plain PyTorch
versions and launch counters.

K1 ``aggregate``: SGM path aggregation over all directions in one launch,
plus one that widens its 16-bit sums (csrc/sgm_aggregate.cu), replacing the
TPU kernel ``sgm_pallas._multi_kernel``.
K2 ``run_total``: speckle-filter run totals (csrc/speckle_run_total.cu),
replacing the TPU kernel ``sgm_pallas._run_total_kernel``.
K3 ``scan_pair``: the single-direction forward + backward scan pair, both
chains in one launch (csrc/sgm_scan_pair.cu), replacing the TPU kernels
``sgm_pallas._fwd_kernel`` and ``sgm_pallas._bwd_kernel``; ``scan_launch``
runs one of the two passes alone. The profilers reach it
(``tools.profile_stages``, ``tools.profile_sgm``).

Device policy: a wrapper given CPU tensors runs the plain version (the CPU
tests' path); given CUDA tensors it launches the kernel, or raises. There is
no fallback from the card to the plain version. ``launch_counts`` grows by
one per kernel launch, only where a kernel is launched, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.utils.cuda_build import check, load_kernels

_BIG = 1e9

# scan directions (dy, dx) in the order 2 / 4 / 8 paths add them
DIRECTIONS = ((0, 1), (0, -1), (1, 0), (-1, 0),
              (1, 1), (-1, -1), (1, -1), (-1, 1))

launch_counts: Dict[str, int] = {"sgm_path": 0, "run_total": 0,
                                 "scan_fwd": 0, "scan_bwd": 0, "scan_pair": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_paths(num_paths: int) -> None:
    if num_paths not in (2, 4, 8):
        raise ValueError(f"num_paths must be 2, 4, or 8, got {num_paths}")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _launch(device: torch.device, entry, *args) -> int:
    """Call a kernel entry point of the library on ``device``'s current
    stream (its last argument); the device context is switched only where
    ``device`` is not the current one, which keeps a launch's host time low."""
    if device.index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))


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


def aggregate_plain(cost: torch.Tensor, p1: float, p2: float,
                    num_paths: int = 4) -> torch.Tensor:
    """Plain PyTorch K1 (sgm.aggregate_scan): cost (H, W, D) -> (H, W, D)
    float32, the sum over 2 (horizontal), 4 (+ vertical) or 8 (+ both
    diagonals) scan paths. A Python loop over scan steps."""
    _check_paths(num_paths)
    cost = cost.to(torch.float32)
    cost_t = cost.transpose(0, 1)
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


# device copies of the line tables, made once per (h, w, paths, device)
_line_tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, np.ndarray]] = {}


def _device_tables(h: int, w: int, num_paths: int, device: torch.device):
    key = (h, w, num_paths, device)
    if key not in _line_tables:
        table, offsets = line_table(h, w, num_paths)
        _line_tables[key] = (torch.from_numpy(longest_first(table)).to(device),
                             torch.from_numpy(table).to(device), offsets)
    return _line_tables[key]


def sums_fit_16_bits(p1: float, p2: float, num_paths: int) -> bool:
    """Whether the sum over directions can be formed in any order in 16-bit
    integers: with uint8 costs and non-negative integer penalties every path
    value is an integer <= 255 + P2, so every partial sum is an integer, and
    below 2^16 where ``num_paths * (255 + P2)`` is."""
    return (float(p1).is_integer() and float(p2).is_integer()
            and p1 >= 0 and p2 >= 0 and num_paths * (255.0 + p2) < 2.0 ** 16)


def aggregate(cost: torch.Tensor, p1: float, p2: float,
              num_paths: int = 4) -> torch.Tensor:
    """SGM path aggregation: cost (H, W, D) -> (H, W, D) float32 sum over
    ``num_paths`` directions.

    On CUDA: K1. It takes uint8 costs (census costs are <= 32) and D a
    multiple of 8 up to 256. With integer penalties that ``sums_fit_16_bits``
    (the defaults) it is two launches: ONE over the scan lines of all
    directions, which add into a zeroed uint16 accumulator by 64-bit integer
    reductions in no fixed order, and one that widens it to float32. Every
    partial sum is an exact integer, so the total is bit-equal to
    ``aggregate_plain`` and the same from run to run. With any other
    penalties an unordered sum would round differently from run to run, so
    the kernel is launched once per direction, in the order of
    ``DIRECTIONS``, over that direction's lines, adding into the float32
    total: a cell then receives one reduction per launch and the stream
    orders the launches, so the result is reproducible, and within f32
    rounding of ``aggregate_plain`` (which sums the directions in pairs).
    ``launch_counts["sgm_path"]`` counts the launches: 2, or ``num_paths``.
    On the CPU: ``aggregate_plain``.
    """
    _check_paths(num_paths)
    if not _on_card(cost):
        return aggregate_plain(cost, p1, p2, num_paths)
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
    lib = load_kernels()
    by_length, by_direction, offsets = _device_tables(h, w, num_paths, cost.device)
    packed = sums_fit_16_bits(p1, p2, num_paths)
    if packed:
        calls = [by_length]
        acc = torch.zeros((h, w, d), dtype=torch.int16, device=cost.device)
        total = torch.empty((h, w, d), dtype=torch.float32, device=cost.device)
    else:
        calls = [by_direction[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
        acc = total = torch.zeros((h, w, d), dtype=torch.float32, device=cost.device)
    for lines in calls:
        rc = _launch(cost.device, lib.o3r_sgm_aggregate, cost.data_ptr(),
                     acc.data_ptr(), lines.data_ptr(), len(lines), d, float(p1),
                     float(p2), int(packed))
        check(lib, rc, "sgm_aggregate kernel")
        launch_counts["sgm_path"] += 1
    if packed:
        rc = _launch(cost.device, lib.o3r_sgm_unpack16, acc.data_ptr(), total.data_ptr(),
                     h * w * d)
        check(lib, rc, "sgm_unpack16 kernel")
        launch_counts["sgm_path"] += 1
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
    if not _on_card(v):
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
    rc = _launch(v.device, lib.o3r_run_total, v.data_ptr(), start.data_ptr(),
                 out.data_ptr(), h, w, axis)
    check(lib, rc, "run_total kernel")
    launch_counts["run_total"] += 1
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
    if not _on_card(cost):
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
    rc = _launch(cost.device, getattr(lib, "o3r_" + name), cost.data_ptr(),
                 out.data_ptr(), s, l, d, _SCAN_DTYPES[cost.dtype], float(p1), float(p2))
    check(lib, rc, f"{name} kernel")
    launch_counts[name] += 1


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
    if not _on_card(cost):
        return scan_pair_plain(cost, p1, p2)
    _check_scan_volume(cost)
    s, l, d = cost.shape
    out = torch.empty_like(cost)
    stash = out if cost.dtype == torch.float32 else torch.empty(
        cost.shape, dtype=torch.float32, device=cost.device)
    lib = load_kernels()
    rc = _launch(cost.device, lib.o3r_scan_pair, cost.data_ptr(), out.data_ptr(),
                 stash.data_ptr(), s, l, d, _SCAN_DTYPES[cost.dtype], float(p1), float(p2))
    check(lib, rc, "scan_pair kernel")
    launch_counts["scan_pair"] += 1
    return out
