"""Semi-global matching disparity (port of stereo/sgm.py).

The stage: census cost volume, path aggregation (K1, ``sgm_cuda.aggregate``),
winner-take-all with uniqueness ratio and subpixel fit, left-right check,
speckle filter (run totals by K2, ``sgm_cuda.run_total``). Two TPU knobs of
``StereoConfig`` are ignored here:

- ``use_pallas``: the device decides. On CUDA tensors the kernels run, on
  CPU tensors their plain versions.
- ``cost_dtype``: aggregation is exact in f32 (integer costs and penalties
  keep every path value an integer); the bf16 storage was a TPU bandwidth
  choice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from online_3d_reconstruction_tpu_torch.config import StereoConfig
from online_3d_reconstruction_tpu_torch.stereo.census import census_transform, cost_volume
from online_3d_reconstruction_tpu_torch.stereo.sgm_cuda import aggregate, aggregate_plain, run_total

_BIG = 1e9
SUBPIXEL_FITS = ("parabola", "vshape")


def aggregate_scan(cost: torch.Tensor, p1: float, p2: float,
                   num_paths: int = 4) -> torch.Tensor:
    """Sum of directional SGM aggregations over 2, 4, or 8 paths, cost
    (H, W, D) -> (H, W, D) float32, as plain PyTorch on the tensor's device
    (the reference's name for ``sgm_cuda.aggregate_plain``; the stage itself
    calls ``sgm_cuda.aggregate``, which runs K1 on the card)."""
    return aggregate_plain(cost, p1, p2, num_paths)


def _skew(cost: torch.Tensor, sign: int, fill: float = _BIG) -> torch.Tensor:
    """Shear the (H, W, D) volume into (H, W + H - 1, D) so that diagonal
    paths become columns, the lines ``sgm_cuda.scan_pair`` scans along axis
    0: sign=+1 maps the (dy=1, dx=1) diagonal to a column (row y
    shifted right by H-1-y), sign=-1 maps (dy=1, dx=-1) (row y shifted right
    by y). Pure pad and reshape, no gather: padding rows from W to W+H
    columns, flattening and re-viewing as rows of W+H-1 shifts row y by y.

    Padding cells hold ``fill``. The reference's 1e9 is the default: a
    carry that crosses such cells arrives uniform, which the recurrence
    normalizes away, but in f32 ``(cost + 1e9) - 1e9`` loses the cost of the
    first real cell, so a path entering from the side differs from a fresh
    start there. ``fill=0.0`` is exact: a zero carry stepped over zero costs
    stays zero, the fresh-start condition at an image border."""
    h, w, d = cost.shape
    out_w = w + h - 1
    if sign > 0:   # shift by H-1-y: flip rows, shift by y, flip back
        cost = cost.flip(0)
    padded = torch.nn.functional.pad(cost, (0, 0, 0, h), value=fill)
    skewed = padded.reshape(h * (w + h), d)[:h * out_w].reshape(h, out_w, d)
    return skewed.flip(0) if sign > 0 else skewed


def _deskew(skewed: torch.Tensor, sign: int, width: int) -> torch.Tensor:
    """Inverse of ``_skew`` on the real image band (no gather):
    out[y, x] = skewed[y, x + shift(y)], by appending H rows to the
    flattened volume and re-viewing it as rows of W+H."""
    h, out_w, d = skewed.shape
    if sign > 0:
        skewed = skewed.flip(0)
    flat = torch.nn.functional.pad(skewed.reshape(h * out_w, d), (0, 0, 0, h))
    out = flat.reshape(h, out_w + 1, d)[:, :width]
    return out.flip(0) if sign > 0 else out


def wta_disparity(aggregated: torch.Tensor, uniqueness_ratio: float = 0.95,
                  subpixel: bool = True, fit: str = "parabola"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all over the last (D) axis of (H, W, D) with uniqueness
    gating (second best over |d - d_best| > 1) and a subpixel fit:
    "parabola" (cv2 SGBM's quadratic) or "vshape" (equiangular lines).
    Returns (disparity (H, W) float32, valid (H, W) bool)."""
    if fit not in SUBPIXEL_FITS:
        raise ValueError(f"subpixel fit must be one of {SUBPIXEL_FITS}, "
                         f"got {fit!r}")
    d = aggregated.shape[-1]
    best_idx = torch.argmin(aggregated, dim=-1)       # first index on ties
    best = torch.gather(aggregated, -1, best_idx[..., None])[..., 0]
    d_range = torch.arange(d, device=aggregated.device)
    off = d_range - best_idx[..., None]
    second = torch.where(off.abs() <= 1, _BIG, aggregated).amin(dim=-1)
    valid = best <= second * uniqueness_ratio

    disp = best_idx.to(torch.float32)
    if subpixel:
        c_m = torch.gather(aggregated, -1,
                           (best_idx - 1).clamp(min=0)[..., None])[..., 0]
        c_p = torch.gather(aggregated, -1,
                           (best_idx + 1).clamp(max=d - 1)[..., None])[..., 0]
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


def lr_consistency_mask(disparity: torch.Tensor, disp_right: torch.Tensor,
                        max_diff: int = 1) -> torch.Tensor:
    """Left pixels whose right-view match, read at round(x - d) by a gather,
    agrees within ``max_diff`` and lies in the image."""
    w = disparity.shape[1]
    x = torch.arange(w, dtype=torch.float32, device=disparity.device)[None, :]
    xr = torch.round(x - disparity).to(torch.int64)
    in_img = (xr >= 0) & (xr < w)
    d_r = torch.gather(disp_right, 1, xr.clamp(0, w - 1))
    return in_img & ((d_r - disparity).abs() <= max_diff)


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


def sgm_disparity(left: torch.Tensor, right: torch.Tensor,
                  config: StereoConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rectified grayscale pair -> (disparity (H, W) float32, valid (H, W)
    bool); invalid pixels carry ``config.invalid_value``. Runs on the
    tensors' device; ``use_pallas`` and ``cost_dtype`` are ignored (see the
    module docstring)."""
    cen_l = census_transform(left, config.census_window)
    cen_r = census_transform(right, config.census_window)
    # census costs are <= 32: uint8 is exact and is what K1 reads
    cost = cost_volume(cen_l, cen_r, config.max_disparity).to(torch.uint8)
    aggregated = aggregate(cost, config.p1, config.p2, config.num_paths)
    disp, valid = wta_disparity(aggregated, config.uniqueness_ratio,
                                config.subpixel, fit=config.subpixel_fit)
    if config.lr_max_diff >= 0:
        disp_r = right_disparity_from_aggregated(aggregated)
        valid = valid & lr_consistency_mask_volume(
            disp, disp_r, config.max_disparity, config.lr_max_diff)
    valid = valid & (disp > 0.0)
    if config.speckle_window > 0:
        valid = speckle_filter(disp, valid, config.speckle_window,
                               config.speckle_range)
    disp = torch.where(valid, disp, config.invalid_value)
    return disp, valid
