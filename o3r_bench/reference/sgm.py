"""Semi-global matching disparity, plain PyTorch (a frozen copy of the
port's ``stereo/sgm.py`` with the plain versions of its two kernels).

The stage: census cost volume, path aggregation over 2, 4 or 8 scan paths
(the plain form of the port's K1, batched over frames), winner-take-all
with uniqueness ratio and subpixel fit, left-right check, speckle filter
(run totals: the plain form of the port's K2). The aggregated volume is
stored as the configuration states (``aggregation_dtype``): bfloat16 or
float16 rounded at the four points where the fused TPU kernel of the JAX
package rounds it, or the exact float32 sum. ``storage="float8_e5m2"``
rounds at the same points to fp8 (e5m2) and holds the values in bfloat16:
the benchmark's lower-precision control. Everything after the aggregation
reads the stored values and computes in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import StereoConfig
from .census import census_transform, cost_volume

_BIG = 1e9
SUBPIXEL_FITS = ("parabola", "vshape")
COST_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}
# the control's storage: fp8 e5m2 values, held in bfloat16 (which holds
# every e5m2 value exactly) so that every reduction after it runs
CONTROL_STORAGE = "float8_e5m2"


def aggregation_dtype(config: StereoConfig) -> torch.dtype:
    """The storage dtype of the aggregated volume under ``config``: the
    ``cost_dtype`` where ``use_pallas`` (the reference's Pallas path, which
    stores in ``jnp.dtype(cost_dtype)``; "bfloat16" by default), else
    float32 (its exact ``lax.scan`` path, which ``use_pallas=False`` takes
    whatever ``cost_dtype`` is). Raises ValueError for a ``cost_dtype``
    other than the three."""
    if config.cost_dtype not in COST_DTYPES:
        raise ValueError(f"cost_dtype must be one of {tuple(COST_DTYPES)}, "
                         f"got {config.cost_dtype!r}")
    return COST_DTYPES[config.cost_dtype] if config.use_pallas else torch.float32


def wta_disparity(aggregated: torch.Tensor, uniqueness_ratio: float = 0.95,
                  subpixel: bool = True, fit: str = "parabola"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all over the last (D) axis of (H, W, D) with uniqueness
    gating (second best over |d - d_best| > 1) and a subpixel fit:
    "parabola" (cv2 SGBM's quadratic) or "vshape" (equiangular lines).
    The reductions run on the volume's own dtype (f32, bf16 or f16) and their
    values are cast to f32 before any arithmetic, as the reference does.
    Returns (disparity (H, W) float32, valid (H, W) bool)."""
    if fit not in SUBPIXEL_FITS:
        raise ValueError(f"subpixel fit must be one of {SUBPIXEL_FITS}, "
                         f"got {fit!r}")
    d = aggregated.shape[-1]
    best_idx = torch.argmin(aggregated, dim=-1)       # first index on ties
    best = torch.gather(aggregated, -1, best_idx[..., None])[..., 0].float()
    d_range = torch.arange(d, device=aggregated.device)
    off = d_range - best_idx[..., None]
    second = torch.where(off.abs() <= 1, _BIG, aggregated).amin(dim=-1).float()
    valid = best <= second * uniqueness_ratio

    disp = best_idx.to(torch.float32)
    if subpixel:
        c_m = torch.gather(aggregated, -1,
                           (best_idx - 1).clamp(min=0)[..., None])[..., 0].float()
        c_p = torch.gather(aggregated, -1,
                           (best_idx + 1).clamp(max=d - 1)[..., None])[..., 0].float()
        if fit == "vshape":
            denom = torch.maximum(c_m, c_p) - best
        else:
            denom = c_m + c_p - 2.0 * best
        offset = torch.where(denom > 1e-6, (c_m - c_p) / (2.0 * denom), 0.0)
        offset = offset.clamp(-0.5, 0.5)
        interior = (best_idx > 0) & (best_idx < d - 1)
        disp = disp + torch.where(interior, offset, 0.0)
    return disp, valid


def right_disparity_from_aggregated(aggregated: torch.Tensor) -> torch.Tensor:
    """Right-view integer WTA disparity from the left volume:
    aggR[y, x, d] = agg[y, x + d, d], out-of-image hypotheses excluded."""
    h, w, d = aggregated.shape
    dev = aggregated.device
    x = torch.arange(w, device=dev)[:, None] + torch.arange(d, device=dev)[None, :]
    sheared = aggregated[:, x.clamp(max=w - 1), torch.arange(d, device=dev)]
    agg_r = torch.where((x >= w)[None], _BIG, sheared)
    return torch.argmin(agg_r, dim=-1).to(torch.float32)


def lr_consistency_mask_volume(disparity: torch.Tensor,
                               disp_right: torch.Tensor, max_disparity: int,
                               max_diff: int = 1) -> torch.Tensor:
    """Left pixels whose right-view match agrees within ``max_diff``: the
    right disparity is read at x - clip(round(d), 0, D - 1) (-1e9 left of
    the image), the in-image test uses round(x - d), as the reference."""
    h, w = disparity.shape
    x = torch.arange(w, device=disparity.device)
    d_round = torch.round(disparity).clamp(0, max_disparity - 1).to(torch.int64)
    col = x[None, :] - d_round
    d_r = torch.where(col >= 0,
                      torch.gather(disp_right, 1, col.clamp(min=0)), -1e9)
    xr = torch.round(x.to(torch.float32)[None, :] - disparity)
    in_img = (xr >= 0) & (xr < w)
    return in_img & ((d_r - disparity).abs() <= max_diff)


def _shift_down(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x moved one step toward higher index along ``axis``, zero fill."""
    if axis == 0:
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def speckle_filter(disparity: torch.Tensor, valid: torch.Tensor,
                   max_size: int, max_diff: float) -> torch.Tensor:
    """Invalidate blobs of <= max_size pixels by the run-cross mass bound
    (sgm.speckle_filter / sgm_pallas.speckle_filter_pallas): run starts per
    axis where a pixel is not connected to its predecessor, four K2 run
    totals, then valid & (mass > max_size). Counts stay exact f32 integers
    (no int16 saturation). Returns the updated (H, W) bool mask."""
    if max_size <= 0:
        return valid
    d = disparity.to(torch.float32)
    val = valid.to(torch.float32)

    def start_flags(axis):
        conn = (val * _shift_down(val, axis)
                * ((d - _shift_down(d, axis)).abs() <= max_diff).to(torch.float32))
        return 1.0 - conn          # row/col 0 starts: the fill is invalid

    f0 = start_flags(0)
    f1 = start_flags(1)
    colrun = run_total(val, f0, axis=0)
    rowrun = run_total(val, f1, axis=1)
    mass = torch.maximum(run_total(colrun, f1, axis=1),
                         run_total(rowrun, f0, axis=0))
    return valid & (mass > float(max_size))




def _sgm_step(carry: torch.Tensor, cost_slice: torch.Tensor, p1: float,
              p2: float) -> torch.Tensor:
    """One recurrence step over lines (..., L, D)."""
    min_prev = carry.min(dim=-1, keepdim=True).values
    edge = torch.full_like(carry[..., :1], _BIG)
    d_minus = torch.cat([edge, carry[..., :-1]], dim=-1) + p1
    d_plus = torch.cat([carry[..., 1:], edge], dim=-1) + p1
    best = torch.minimum(torch.minimum(carry, min_prev + p2),
                         torch.minimum(d_minus, d_plus))
    return cost_slice + best - min_prev


def _scan_path(cost: torch.Tensor, p1: float, p2: float, reverse: bool,
               shift: int = 0) -> torch.Tensor:
    """Aggregate along axis 1 of (B, S, L, D); ``shift`` +-1 makes the
    carry's predecessor the neighbouring line, zero-filled at the edge (a
    diagonal starting fresh at the image border), flipped for the reverse
    pass."""
    eff = -shift if reverse else shift
    out = torch.empty_like(cost)
    carry = torch.zeros_like(cost[:, 0])
    order = range(cost.shape[1] - 1, -1, -1) if reverse else range(cost.shape[1])
    zero = torch.zeros_like(carry[:, :1])
    for s in order:
        if eff > 0:
            carry = torch.cat([zero, carry[:, :-1]], dim=1)
        elif eff < 0:
            carry = torch.cat([carry[:, 1:], zero], dim=1)
        carry = _sgm_step(carry, cost[:, s], p1, p2)
        out[:, s] = carry
    return out


def _store(x: torch.Tensor, storage) -> torch.Tensor:
    """``x`` rounded to the storage: a dtype, or the control's fp8."""
    if storage == CONTROL_STORAGE:
        return x.to(torch.float8_e5m2).to(torch.bfloat16)
    return x.to(storage)


def aggregate(cost: torch.Tensor, p1: float, p2: float, num_paths: int,
              storage) -> torch.Tensor:
    """cost (B, H, W, D) -> (B, H, W, D): the sum over 2 (horizontal), 4
    (+ vertical) or 8 (+ both diagonals) scan paths, in ``storage``.
    float32: the exact sum, directions added in pairs. A half storage: the
    carries stay f32 and the total is rounded (r) four times,
    ``r(r(r(r(h_fwd) + h_bwd) + tri_fwd) + tri_bwd)``, each group added to
    the f32 value of the rounded total in the TPU kernel's order
    (vertical, then the +1 and the -1 diagonal). With 4 paths a tri group
    is its vertical direction alone; with 2 paths the total is
    ``r(r(h_fwd) + h_bwd)``."""
    if num_paths not in (2, 4, 8):
        raise ValueError(f"num_paths must be 2, 4, or 8, got {num_paths}")
    cost = cost.to(torch.float32)
    cost_t = cost.transpose(1, 2)
    if storage != torch.float32:
        total = _store(_scan_path(cost_t, p1, p2, False).transpose(1, 2), storage)
        total = _store(total.to(torch.float32)
                       + _scan_path(cost_t, p1, p2, True).transpose(1, 2), storage)
        if num_paths >= 4:
            shifts = (0, 1, -1) if num_paths == 8 else (0,)
            for reverse in (False, True):
                acc = total.to(torch.float32)
                for shift in shifts:
                    acc = acc + _scan_path(cost, p1, p2, reverse, shift=shift)
                total = _store(acc, storage)
        return total.contiguous()
    total = (_scan_path(cost_t, p1, p2, False)
             + _scan_path(cost_t, p1, p2, True)).transpose(1, 2)
    if num_paths >= 4:
        total = (total + _scan_path(cost, p1, p2, False)
                 + _scan_path(cost, p1, p2, True))
    if num_paths == 8:
        for shift in (1, -1):
            total = (total + _scan_path(cost, p1, p2, False, shift=shift)
                     + _scan_path(cost, p1, p2, True, shift=shift))
    return total.contiguous()


def run_total(v: torch.Tensor, start: torch.Tensor, axis: int) -> torch.Tensor:
    """Per pixel of (H, W), the sum of ``v`` over its maximal run along
    ``axis``; a run starts where ``start`` > 0.5 and at index 0. Exact for
    integer-valued v whose run sums stay below 2^24."""
    vt = (v if axis == 1 else v.t()).to(torch.float32)
    st = (start if axis == 1 else start.t()) > 0.5
    st = st.clone()
    st[:, 0] = True
    seg = torch.cumsum(st.reshape(-1).to(torch.int64), 0) - 1
    sums = torch.zeros(int(vt.numel()), dtype=torch.float32, device=v.device)
    sums.index_add_(0, seg, vt.reshape(-1))
    out = sums[seg].reshape(vt.shape)
    return (out if axis == 1 else out.t()).contiguous()


def sgm_disparity_batch(lefts: torch.Tensor, rights: torch.Tensor,
                        config: StereoConfig, storage=None) -> torch.Tensor:
    """Rectified grayscale pairs (B, H, W) -> disparities (B, H, W) float32,
    invalid pixels carrying ``config.invalid_value``. ``storage`` defaults
    to the configuration's (``aggregation_dtype``)."""
    storage = aggregation_dtype(config) if storage is None else storage
    costs = torch.stack([
        cost_volume(census_transform(l, config.census_window),
                    census_transform(r, config.census_window),
                    config.max_disparity).to(torch.uint8)
        for l, r in zip(lefts, rights)])
    aggregated = aggregate(costs, config.p1, config.p2, config.num_paths, storage)
    del costs
    out = []
    for agg in aggregated:
        disp, valid = wta_disparity(agg, config.uniqueness_ratio,
                                    config.subpixel, fit=config.subpixel_fit)
        if config.lr_max_diff >= 0:
            disp_r = right_disparity_from_aggregated(agg)
            valid = valid & lr_consistency_mask_volume(
                disp, disp_r, config.max_disparity, config.lr_max_diff)
        valid = valid & (disp > 0.0)
        if config.speckle_window > 0:
            valid = speckle_filter(disp, valid, config.speckle_window,
                                   config.speckle_range)
        out.append(torch.where(valid, disp, config.invalid_value))
    return torch.stack(out)
