"""Row-slab sharded SGM (P4): one image's rows split over the ranks (port
of parallel/sgm_sharded.py).

The SGM path scan is a sequential recurrence along rows, columns and
diagonals. To split one image over ranks the rows are cut into slabs, and
each rank aggregates over its slab *plus a halo of overlap rows* fetched
from its neighbours with one exchange per direction before the scan.

Exactness: horizontal paths never cross slab boundaries and are exact.
Vertical and diagonal paths are truncated at the halo edge, the standard
tiled-SGM approximation: the recurrence clamps a path's carry within P2 of
the running minimum, so its influence decays, and a halo of 16-32 rows
makes interior pixels match the monolithic result almost everywhere. On a
mesh of ONE rank the halos are zero rows on both sides, so vertical paths
start in that zero band and the result is close to, not equal to,
``sgm_disparity`` (in the reference as here).

The aggregation of every slab is ``sgm_cuda.aggregate``: K1 on the card (at
slab + 2 * halo rows), its plain version on the CPU. The speckle filter is
global connectivity and runs replicated after the gather (K2 on the card).
The reference's ``use_pallas`` branch and its (H, D, W) layout were TPU
adapters and have no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from online_3d_reconstruction_tpu_torch.config import StereoConfig
from online_3d_reconstruction_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    axis_index,
    shift,
)
from online_3d_reconstruction_tpu_torch.stereo.census import census_transform, cost_volume
from online_3d_reconstruction_tpu_torch.stereo.sgm import (
    lr_consistency_mask_volume,
    right_disparity_from_aggregated,
    speckle_filter,
    wta_disparity,
)
from online_3d_reconstruction_tpu_torch.stereo.sgm_cuda import aggregate


def _exchange_halos(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """Prepend the previous rank's last ``halo`` rows and append the next
    rank's first ``halo`` rows: (S, ...) -> (S + 2 * halo, ...). The edge
    ranks get zero rows (as at an image border)."""
    from_prev = shift(x[-halo:], mesh, 1)
    from_next = shift(x[:halo], mesh, -1)
    return torch.cat([from_prev, x, from_next], dim=0)


def stage(left_s: torch.Tensor, right_s: torch.Tensor, config: StereoConfig,
          mesh: Mesh, halo: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's slab of rows -> its (disparity, valid) before the speckle
    filter: census on the slab extended by ``halo + census_window // 2``
    rows, the cost volume cropped back to slab + 2 * halo rows, aggregation,
    the interior kept, then WTA, the left-right check and ``disp > 0``."""
    slab = left_s.shape[0]
    cw = max(config.census_window) // 2
    pad = halo + cw
    cen_l = census_transform(_exchange_halos(left_s, pad, mesh), config.census_window)
    cen_r = census_transform(_exchange_halos(right_s, pad, mesh), config.census_window)
    # census costs are <= 32: uint8 is exact and is what K1 reads
    cost = cost_volume(cen_l, cen_r, config.max_disparity).to(torch.uint8)
    cost = cost[cw:-cw] if cw else cost     # keep slab + aggregation halo
    agg = aggregate(cost, config.p1, config.p2, config.num_paths)
    agg = agg[halo:halo + slab]             # interior only
    disp, valid = wta_disparity(agg, config.uniqueness_ratio, config.subpixel,
                                fit=config.subpixel_fit)
    if config.lr_max_diff >= 0:
        valid = valid & lr_consistency_mask_volume(
            disp, right_disparity_from_aggregated(agg), config.max_disparity,
            config.lr_max_diff)
    return disp, valid & (disp > 0.0)


def sharded_disparity(left: torch.Tensor, right: torch.Tensor, config: StereoConfig,
                      mesh: Mesh, halo: int = 32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stereo pair, rows sharded over the mesh: (H, W) -> (disparity
    (H, W) float32, valid (H, W) bool) on every rank.

    H must divide by the mesh size and the slab height must exceed the
    halo. Each rank runs ``stage`` on its slab; the slabs are gathered and
    the speckle filter runs replicated on the whole image.
    """
    h = left.shape[0]
    if h % mesh.size:
        raise ValueError(f"height {h} not divisible by {mesh.size} devices")
    slab = h // mesh.size
    if slab <= halo:
        raise ValueError(f"slab {slab} rows must exceed halo {halo}")
    rows = slice(axis_index(mesh) * slab, (axis_index(mesh) + 1) * slab)
    disp, valid = stage(left[rows].to(mesh.device), right[rows].to(mesh.device),
                        config, mesh, halo)
    disp, valid = all_gather(disp, mesh), all_gather(valid, mesh)
    if config.speckle_window > 0:
        valid = speckle_filter(disp, valid, config.speckle_window, config.speckle_range)
    return torch.where(valid, disp, config.invalid_value), valid
