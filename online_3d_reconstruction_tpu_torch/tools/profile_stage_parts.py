"""The disparity stage timed part by part (port of
tools/profile_stage_parts.py): census, cost volume, aggregation (K1), WTA,
right disparity, the LR check, the speckle filter (K2), the full
``sgm_disparity``.

    python -m online_3d_reconstruction_tpu_torch.tools.profile_stage_parts
        [--device cuda] [--size 384 512 64]

Rows carry the reference tool's names. Where that name is a TPU form the
port does not run (the (H, D, W) layout's ``cost_volume_dl`` and
``right_disparity_dl``, the bf16 cost volume and its f32->bf16 cast), the
port's form is timed under the reference's name plus `` [port:
<function>]``; the census and cost volume row times K4, both images'
census and the uint8 volume in one launch, and the plain chain beside it
is a row of the port's own. The aggregation is stored in bf16, as the
reference's. The LR check's gather form (``lr_consistency_mask``) is timed
beside the volume form, a row of the port's own. Each row is
``utils.roofline.measure_amortized``: on a card, device time between CUDA
events over back-to-back calls; on the CPU, the host clock.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.config import StereoConfig
from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
from online_3d_reconstruction_tpu_torch.stereo.census import census_transform
from online_3d_reconstruction_tpu_torch.stereo.sgm import (
    lr_consistency_mask,
    lr_consistency_mask_volume,
    right_disparity_from_aggregated,
    sgm_disparity,
    speckle_filter,
    wta_disparity,
)
from online_3d_reconstruction_tpu_torch.stereo.sgm_cuda import (
    aggregate,
    census_cost,
    census_cost_plain,
)
from online_3d_reconstruction_tpu_torch.utils.roofline import measure_amortized


def main(height: int = 384, width: int = 512, disparity: int = 64,
         device: "torch.device | str" = "cuda") -> List[Tuple[str, float]]:
    """Time each part at (height, width, disparity) on ``device``, print
    one line per row and return [(name, ms), ...]."""
    dev = resolve_device(device)
    h, w, d = height, width, disparity
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", flush=True)
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
    right = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
    rows: List[Tuple[str, float]] = []

    def bench(label, fn, args, inner):
        ms = measure_amortized(fn, args, inner=inner) * 1e3
        rows.append((label, ms))
        print(f"{label}: {ms:.3f} ms", flush=True)

    bench("census x1", lambda l: census_transform(l, (5, 5)), (left,), 32)
    bench("census+cost_volume_dl->bf16 [port: sgm_cuda.census_cost, both images -> uint8]",
          lambda l: census_cost(l, right, (5, 5), d), (left,), 16)
    bench("census x2 + cost_volume -> uint8 (port only) [port: plain chain]",
          lambda l: census_cost_plain(l, right, (5, 5), d), (left,), 16)
    cost = census_cost(left, right, (5, 5), d)
    bench("aggregate_fused 8p bf16 (incl f32->bf16 cast in) "
          "[port: sgm_cuda.aggregate, uint8 in]",
          lambda c: aggregate(c, 8.0, 32.0, 8, torch.bfloat16), (cost,), 16)
    agg = aggregate(cost, 8.0, 32.0, 8, torch.bfloat16)
    bench("wta (d_axis=1) [port: wta_disparity, D last]",
          lambda a: wta_disparity(a, 0.95, True), (agg,), 16)
    bench("right_disparity_dl [port: right_disparity_from_aggregated]",
          right_disparity_from_aggregated, (agg,), 16)
    disp, valid = wta_disparity(agg, 0.95, True)
    disp_r = right_disparity_from_aggregated(agg)
    bench("lr_consistency (volume form)",
          lambda dd: lr_consistency_mask_volume(dd, disp_r, d, 1), (disp,), 32)
    bench("lr_consistency (gather form, port only) [port: lr_consistency_mask]",
          lambda dd: lr_consistency_mask(dd, disp_r, 1), (disp,), 32)
    bench("speckle_filter (run-cross mass)",
          lambda dd: speckle_filter(dd, valid, 50, 1.0), (disp,), 8)
    cfg = StereoConfig(height=h, width=w, max_disparity=d, num_paths=8, use_pallas=True)
    bench("FULL sgm_disparity 8-path bf16",
          lambda l, r: sgm_disparity(l, r, cfg)[0], (left, right), 8)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, nargs=3, default=(384, 512, 64),
                        metavar=("HEIGHT", "WIDTH", "DISPARITY"))
    args = parser.parse_args()
    main(*args.size, device=args.device)
