"""Per-stage timings of the online-loop components (port of
tools/profile_stages.py), one row per stage under the reference tool's
names, on the device it is given.

    python -m online_3d_reconstruction_tpu_torch.tools.profile_stages
        [--device cuda] [--size 384 512 64]

Each row is ``utils.roofline.measure_amortized``: on a CUDA card, device
time between CUDA events over back-to-back calls; on the CPU, the host
clock. The SGM rows run the hand-written kernels on a card: K4 for the
census of both images and the cost volume (beside it the plain chain, a
``[port only]`` row), K1 for the 8-path aggregation (the reference row's f32 storage, and beside it the bf16
form in a row of the port's own, ``[port only]``, which the total leaves
out), K2 inside the speckle filter, K3 for the vertical scan pair (one
launch a call; ``tools.profile_sgm`` times its other shapes). The full
``sgm_disparity`` row runs the reference's configuration on its own chip
(``use_pallas=True``: the bf16 aggregation).
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.ba.schur import solve_ba
from online_3d_reconstruction_tpu_torch.ba.testing import make_synthetic_bundle
from online_3d_reconstruction_tpu_torch.config import (
    FeatureConfig,
    MappingConfig,
    StereoConfig,
)
from online_3d_reconstruction_tpu_torch.features.brief import detect_and_describe
from online_3d_reconstruction_tpu_torch.features.match import match_descriptors
from online_3d_reconstruction_tpu_torch.geometry.backproject import backproject_disparity
from online_3d_reconstruction_tpu_torch.io import identity_rig
from online_3d_reconstruction_tpu_torch.mapping.global_map import (
    create_map,
    downsample_map,
    insert_cloud,
)
from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
from online_3d_reconstruction_tpu_torch.stereo.rectify import rectify_pair
from online_3d_reconstruction_tpu_torch.stereo.sgm import (
    right_disparity_from_aggregated,
    sgm_disparity,
    speckle_filter,
    wta_disparity,
)
from online_3d_reconstruction_tpu_torch.stereo.sgm_cuda import (
    aggregate,
    census_cost,
    census_cost_plain,
    scan_pair,
)
from online_3d_reconstruction_tpu_torch.utils.roofline import measure_amortized

TOTAL = "TOTAL (sum of stages)"
PORT_ONLY = " [port only]"        # a row the reference has not; not in the total


def main(height: int = 384, width: int = 512, disparity: int = 64,
         device: "torch.device | str" = "cuda") -> List[Tuple[str, float]]:
    """Time every stage at (height, width, disparity) on ``device``, print
    one line per stage and the total, and return [(name, ms), ...] with
    the total last."""
    dev = resolve_device(device)
    h, w, d = height, width, disparity
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a).to(dev)

    img = t(rng.random((h, w), np.float32))
    color = t(rng.random((h, w, 3), np.float32))
    cost = t(rng.integers(0, 24, (h, w, d)).astype(np.float32))
    cost_u8 = cost.to(torch.uint8)     # what K1 reads (census costs are <= 32)
    rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                       width=w, height=h)
    q = t(np.asarray(rig.q, np.float32))
    map_l = t(np.asarray(rig.map_left, np.float32))
    map_r = t(np.asarray(rig.map_right, np.float32))
    scfg = StereoConfig(height=h, width=w, max_disparity=d, num_paths=8, use_pallas=True)
    fcfg = FeatureConfig(max_keypoints=512)
    mcfg = MappingConfig()

    rows: List[Tuple[str, float]] = []

    def bench(label, fn, args, **kw):
        ms = measure_amortized(fn, args, **kw) * 1e3
        rows.append((label, ms))
        print(f"{label:32s} {ms:8.3f} ms", flush=True)

    bench("rectify_pair", lambda l: rectify_pair(l, img, map_l, map_r), (img,))
    bench("census(5x5) x2 + cost_volume", lambda l: census_cost(l, img, (5, 5), d), (img,))
    bench("census(5x5) x2 + cost_volume [port: plain chain]" + PORT_ONLY,
          lambda l: census_cost_plain(l, img, (5, 5), d), (img,))
    bench("sgm aggregate 8-path", lambda c: aggregate(c, 8.0, 32.0, 8), (cost_u8,))
    bench("sgm aggregate 8-path bf16" + PORT_ONLY,
          lambda c: aggregate(c, 8.0, 32.0, 8, torch.bfloat16), (cost_u8,))
    bench("scan_pair (vertical only)", lambda c: scan_pair(c, 8.0, 32.0), (cost,))
    agg = aggregate(cost_u8, 8.0, 32.0, 8)
    bench("wta+subpixel", lambda a: wta_disparity(a, 0.95, True)[0], (agg,))
    bench("right_disp (LR)", right_disparity_from_aggregated, (agg,))
    disp0, _ = wta_disparity(agg, 0.95, True)
    bench("speckle_filter", lambda x: speckle_filter(x, x > 0, 50, 1.0), (disp0,),
          inner=4)
    bench("sgm_disparity FULL", lambda l: sgm_disparity(l, img, scfg)[0], (img,),
          inner=4)
    bench("detect_and_describe", lambda l: detect_and_describe(l, fcfg), (img,))
    desc = t(rng.integers(0, 2**32, (512, 8), dtype=np.uint32).astype(np.int64))
    va = torch.ones(512, dtype=torch.bool, device=dev)
    bench("match 512x512", match_descriptors, (desc, desc, va, va))
    bench("backproject s2",
          lambda x: backproject_disparity(x, color, q, stride=2, min_depth=1.0,
                                          max_depth=60.0),
          (disp0,))
    # the pool fills with this frame's cloud over the insert row's calls, so
    # the downsample row voxelizes a partly filled 2M pool
    gmap = create_map(mcfg.map_capacity, dev)
    cloud = backproject_disparity(disp0, color, q, stride=2, min_depth=1.0,
                                  max_depth=60.0)
    bench("insert_cloud (2M pool)", lambda c: insert_cloud(gmap, c), (cloud,), inner=4)
    bench("downsample_map (2M pool)", lambda m: downsample_map(m, 0.25, 2048.0),
          (gmap,), inner=3)

    problem, _, _ = make_synthetic_bundle(np.random.default_rng(1), w=8, l=512,
                                          obs_noise=0.02, n_cap=4096, device=dev)
    bench("solve_ba w8 l512 n4096 it5",
          lambda p: solve_ba(p, iters=5, damping=1e-4, huber_delta=0.5),
          (problem,), inner=4)

    total = sum(ms for name, ms in rows if not name.endswith(PORT_ONLY))
    rows.append((TOTAL, total))
    print(f"{TOTAL:32s} {total:8.3f} ms", flush=True)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, nargs=3, default=(384, 512, 64),
                        metavar=("HEIGHT", "WIDTH", "DISPARITY"))
    args = parser.parse_args()
    main(*args.size, device=args.device)
