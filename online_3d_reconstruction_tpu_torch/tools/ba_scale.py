"""The window solve at W = 8..100 keyframes (port of tools/ba_scale.py).

    python -m online_3d_reconstruction_tpu_torch.tools.ba_scale
        [--device cuda] [--iters 5] [--w 8 32 64 100] [--json build/ba_scale.json]

The dense-block Schur design only earns its architecture at a large window,
where the reduced camera system is a real 6W x 6W Cholesky and the
observation accumulations dominate. Measures the time of ``solve_ba`` and
its Gauss-Newton iterations a second across W on the slot-major
accumulation (``ba.schur.accumulate_normal_blocks(slot_major=...)``, which
keeps the landmark accumulations O(N L) where the generic one is O(N W L)),
with L = min(32 W, 2048) landmarks and min(L, 512) observations a keyframe.
Times are ``utils.roofline.measure_amortized``: on a card, CUDA events over
back-to-back solves.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.ba.schur import solve_ba
from online_3d_reconstruction_tpu_torch.ba.testing import make_synthetic_bundle
from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
from online_3d_reconstruction_tpu_torch.utils.roofline import measure_amortized


def main(argv=None) -> dict:
    """Prints one row per window size, writes them as JSON and returns them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", default=os.path.join("build", "ba_scale.json"))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--w", type=int, nargs="+", default=(8, 32, 64, 100),
                    help="window sizes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    print(f"device: {device_name}  gn_iters: {args.iters}")
    print(f"{'W':>4} {'L':>5} {'obs':>7} {'solve_ms':>9} {'iters/s':>8} "
          f"{'pose_err':>9}")
    rows = []
    for w in args.w:
        l = min(32 * w, 2048)
        k_obs = min(l, 512)   # K keypoint observations a frame over L >> K
        n_obs = w * k_obs     # slot-major: exactly k_obs per keyframe slot
        problem, gt_poses, _ = make_synthetic_bundle(
            np.random.default_rng(0), w=w, l=l, obs_noise=0.02, n_cap=n_obs,
            obs_per_kf=k_obs, device=dev)

        def run(p, k_obs=k_obs):
            return solve_ba(p, iters=args.iters, damping=1e-4, huber_delta=0.5,
                            slot_major=k_obs)

        sec = measure_amortized(run, (problem,), inner=4)
        poses_ref = run(problem)[0].cpu().numpy()
        err = float(np.linalg.norm(poses_ref[:, :3, 3] - gt_poses[:, :3, 3], axis=-1).mean())
        ips = args.iters / sec if sec > 0 else float("nan")
        print(f"{w:>4} {l:>5} {n_obs:>7} {sec*1e3:>9.2f} {ips:>8.1f} "
              f"{err:>9.4f}")
        rows.append({"w": w, "l": l, "obs": n_obs, "solve_s": sec,
                     "gn_iters_per_s": ips, "mean_pose_err_m": err})

    result = {"device": device_name, "gn_iters": args.iters, "rows": rows}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
        print("written:", args.json)
    return result


if __name__ == "__main__":
    main()
