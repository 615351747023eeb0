"""Stereo depth for one pair (port of apps/depth.py): rectify when
``--calib`` is given, SGM disparity (the CUDA kernels on a card), then
disparity.npy and optionally cloud.ply under ``--output``.

  python -m online_3d_reconstruction_tpu_torch.apps.depth --left l.npy --right r.npy \\
      --calib calib.json --output out/ [--cloud] [--set stereo.max_disparity=128]
  python -m online_3d_reconstruction_tpu_torch.apps.depth --synthetic --output out/
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--calib", help="calibration JSON (omit if pre-rectified)")
    p.add_argument("--synthetic", action="store_true",
                   help="use a rendered synthetic pair + report GT error")
    p.add_argument("--output", default="out")
    p.add_argument("--cloud", action="store_true", help="also write cloud.ply")
    p.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default, no fallback) or cpu")
    args = p.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)

    import torch

    from online_3d_reconstruction_tpu_torch.config import load_config
    from online_3d_reconstruction_tpu_torch.geometry.backproject import backproject_disparity
    from online_3d_reconstruction_tpu_torch.io import (
        ImageFolderSequence,
        identity_rig,
        load_calibration_json,
        stereo_rectify,
    )
    from online_3d_reconstruction_tpu_torch.io.export import save_ply
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
    from online_3d_reconstruction_tpu_torch.stereo.rectify import rectify_pair
    from online_3d_reconstruction_tpu_torch.stereo.sgm import sgm_disparity

    device = resolve_device(args.device)
    overrides = {}
    for item in args.set:
        key, _, val = item.partition("=")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    cfg = load_config(None, overrides)

    gt = None
    if args.synthetic:
        from online_3d_reconstruction_tpu_torch.io import Plateau, SyntheticScene, nadir_pose

        h, w = cfg.stereo.height, cfg.stereo.width
        rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2,
                           baseline=0.5, width=w, height=h)
        scene = SyntheticScene(seed=5, plateaus=[Plateau(-6, 6, -4, 8, 8.0)])
        frame = scene.render_stereo(nadir_pose(0, 0, 30.0), rig)
        left, right, color = frame.left, frame.right, frame.left_rgb
        gt = frame.gt_disparity
    else:
        if not (args.left and args.right):
            raise SystemExit("need --left/--right or --synthetic")
        left = ImageFolderSequence._load_image(args.left)
        right = ImageFolderSequence._load_image(args.right)
        if left.ndim == 3:
            color, left = left, left.mean(axis=-1)
            right = right.mean(axis=-1) if right.ndim == 3 else right
        else:
            color = np.repeat(left[..., None], 3, axis=-1)
        if args.calib:
            rig = stereo_rectify(load_calibration_json(args.calib))
        else:
            h, w = left.shape
            rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2,
                               baseline=0.5, width=w, height=h)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    left_t, right_t = t(left), t(right)
    if args.calib:
        left_t, right_t = rectify_pair(left_t, right_t, t(rig.map_left), t(rig.map_right))
    disp, valid = sgm_disparity(left_t, right_t, cfg.stereo)
    disp_np, valid_np = disp.cpu().numpy(), valid.cpu().numpy()
    np.save(os.path.join(args.output, "disparity.npy"), disp_np)

    msg = {
        "device": str(device),
        "valid_fraction": float(valid_np.mean()),
        "disparity_range": [float(disp_np[valid_np].min()) if valid_np.any() else 0.0,
                            float(disp_np.max())],
    }
    if gt is not None:
        m = valid_np & np.isfinite(gt)
        msg["bad_gt_1px"] = float((np.abs(disp_np[m] - gt[m]) > 1.0).mean())
    if args.cloud:
        cloud = backproject_disparity(disp, t(color), t(rig.q),
                                      stride=cfg.mapping.frame_point_stride,
                                      min_depth=cfg.mapping.min_depth,
                                      max_depth=cfg.mapping.max_depth)
        ok = cloud.valid.cpu().numpy()
        save_ply(os.path.join(args.output, "cloud.ply"),
                 cloud.points.cpu().numpy()[ok], cloud.colors.cpu().numpy()[ok])
        msg["cloud_points"] = int(ok.sum())
    print(json.dumps(msg), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
