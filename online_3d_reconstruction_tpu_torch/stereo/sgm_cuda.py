"""The disparity stage's two hand-written CUDA kernels, with their plain
PyTorch versions and launch counters.

K1 ``aggregate``: SGM path aggregation (csrc/sgm_aggregate.cu), replacing
the TPU kernel ``sgm_pallas._multi_kernel``.
K2 ``run_total``: speckle-filter run totals (csrc/speckle_run_total.cu),
replacing the TPU kernel ``sgm_pallas._run_total_kernel``.

Device policy: a wrapper given CPU tensors runs the plain version (the CPU
tests' path); given CUDA tensors it launches the kernel, or raises. There is
no fallback from the card to the plain version. ``launch_counts`` grows by
one per kernel launch, only where a kernel is launched, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

import torch

from online_3d_reconstruction_tpu_torch.utils.cuda_build import check, load_kernels

_BIG = 1e9

# scan directions (dy, dx) in the order 2 / 4 / 8 paths add them
DIRECTIONS = ((0, 1), (0, -1), (1, 0), (-1, 0),
              (1, 1), (-1, -1), (1, -1), (-1, 1))

launch_counts: Dict[str, int] = {"sgm_path": 0, "run_total": 0}


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


def aggregate(cost: torch.Tensor, p1: float, p2: float,
              num_paths: int = 4) -> torch.Tensor:
    """SGM path aggregation: cost (H, W, D) -> (H, W, D) float32 sum over
    ``num_paths`` directions.

    On CUDA: K1, one launch per direction adding into a zeroed f32 total.
    It takes uint8 costs (census costs are <= 32) and D a multiple of 8 up
    to 256. With integer costs and integer P1, P2 the total is bit-equal to
    ``aggregate_plain``. On the CPU: ``aggregate_plain``.
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
    lib = load_kernels()
    total = torch.zeros((h, w, d), dtype=torch.float32, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        for dy, dx in DIRECTIONS[:num_paths]:
            rc = lib.o3r_sgm_path(cost.data_ptr(), total.data_ptr(), h, w, d,
                                  dy, dx, float(p1), float(p2), stream)
            check(lib, rc, "sgm_path kernel")
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


def run_total(v: torch.Tensor, start: torch.Tensor, axis: int) -> torch.Tensor:
    """Run totals of v (H, W) float32 along ``axis`` (0: down columns, 1:
    along rows), runs split at ``start`` (H, W) float32 0/1 flags.

    On CUDA: K2, one launch. On the CPU: ``run_total_plain``.
    """
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if not _on_card(v):
        return run_total_plain(v, start, axis)
    for name, t in (("v", v), ("start", start)):
        if (t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous()
                or t.device != v.device):
            raise ValueError(f"K2 takes contiguous (H, W) float32 {name} on "
                             f"{v.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if start.shape != v.shape:
        raise ValueError(f"start {tuple(start.shape)} != v {tuple(v.shape)}")
    h, w = v.shape
    lib = load_kernels()
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.o3r_run_total(v.data_ptr(), start.data_ptr(), out.data_ptr(),
                               h, w, axis, stream)
    check(lib, rc, "run_total kernel")
    launch_counts["run_total"] += 1
    return out
