"""Build the lab scene's SGM disparity cache (port of
tools/sgm_cache_tpu.py) and measure the disparity error at the keypoints.

    python -m online_3d_reconstruction_tpu_torch.tools.sgm_cache
        [--frames 32] [--out build/sgm_cache.npz] [--distorted] [--u8]
        [--device cuda] [--size 384 512 64]

Renders the lab survey (``tools.lab_scene``: identity rig, supersample 2),
runs the 8-path ``sgm_disparity`` on every frame (on a card: the
aggregation kernel twice and the run-total kernel four times a frame) and
writes the maps as an NPZ with key ``disparity``, which ``tools.ate_lab
--sgm-cache`` and ``tools.bias_vs_edge`` read. Per frame it prints the
disparity error at the subpixel FAST keypoints against the scene's exact
disparity: the noise that enters the 3D lifts, which
``BAConfig.sigma_disparity`` describes.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.features.fast import detect_keypoints
from online_3d_reconstruction_tpu_torch.io import FrameData
from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
from online_3d_reconstruction_tpu_torch.stereo.rectify import rectify_pair
from online_3d_reconstruction_tpu_torch.stereo.sgm import sgm_disparity
from online_3d_reconstruction_tpu_torch.tools import lab_scene


def keypoint_pixels(left: torch.Tensor, height: int, width: int):
    """(u, v) integer pixel of every valid subpixel FAST keypoint of the
    rectified left image (the lab's 512 keypoints at threshold 5)."""
    kxy, _, kok = detect_keypoints(left, max_keypoints=lab_scene.MAX_KEYPOINTS,
                                   threshold=lab_scene.FAST_THRESHOLD / 255.0,
                                   subpixel=True)
    kxy = kxy.cpu().numpy()[kok.cpu().numpy()]
    u = np.clip(np.round(kxy[:, 0]).astype(int), 0, width - 1)
    v = np.clip(np.round(kxy[:, 1]).astype(int), 0, height - 1)
    return u, v


def _through_8_bits(image: np.ndarray) -> np.ndarray:
    q8 = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return q8.astype(np.float32) / 255.0


def main(argv=None, frames: Optional[Sequence[FrameData]] = None) -> dict:
    """``frames``: the survey's frames where the caller has rendered them
    already. Returns the maps, the per-frame statistics (mean, rms, mean
    absolute error, count) and the seconds spent rendering and in SGM."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--out", default=os.path.join("build", "sgm_cache.npz"))
    ap.add_argument("--distorted", action="store_true",
                    help="raw distorted render, rectified before SGM as the "
                         "pipeline does: what the rectification chain costs "
                         "against the identity rig's numbers")
    ap.add_argument("--u8", action="store_true",
                    help="quantize the raw views to 8 bits first (the "
                         "pipeline's packed frame format)")
    lab_scene.add_arguments(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w, _ = args.size

    sequence = lab_scene.make_sequence(args.frames, args.size, distorted=args.distorted)
    scfg = lab_scene.base_config(args.size).stereo
    if args.distorted:
        map_l = torch.as_tensor(sequence.rig.map_left, dtype=torch.float32, device=dev)
        map_r = torch.as_tensor(sequence.rig.map_right, dtype=torch.float32, device=dev)

    given = None if frames is None else lab_scene.render(sequence, frames)
    maps, stats = [], []
    t_render = t_sgm = 0.0
    for i in range(len(sequence)):
        t0 = time.perf_counter()
        f = sequence[i] if given is None else given[i]
        t_render += time.perf_counter() - t0
        t0 = time.perf_counter()
        left_np, right_np = f.left, f.right
        if args.u8:
            left_np, right_np = _through_8_bits(left_np), _through_8_bits(right_np)
        left = torch.as_tensor(left_np, device=dev)
        right = torch.as_tensor(right_np, device=dev)
        if args.distorted:
            left, right = rectify_pair(left, right, map_l, map_r)
        dd, _ = sgm_disparity(left, right, scfg)
        dd_np = dd.cpu().numpy()      # waits for the device
        t_sgm += time.perf_counter() - t0
        maps.append(dd_np)

        # the error at the keypoints (what enters the 3D lifts), not the
        # dense bad-pixel rate; the frame carries the scene's exact disparity
        u, v = keypoint_pixels(left, h, w)
        d_sgm = dd_np[v, u]
        d_gt = np.asarray(f.disparity)[v, u]
        ok = (d_sgm > 0) & (d_gt > 0)
        err = d_sgm[ok] - d_gt[ok]
        stats.append((err.mean(), np.sqrt((err ** 2).mean()), np.abs(err).mean(), ok.sum()))
        print(f"frame {i:3d}: kp disp err mean {err.mean():+.3f} "
              f"rms {np.sqrt((err**2).mean()):.3f} px  (n={ok.sum()})", flush=True)

    disp_all = np.stack(maps)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, disparity=disp_all)
    s = np.asarray(stats)
    print(f"\nwrote {args.out}  render {t_render:.1f}s  sgm {t_sgm:.1f}s")
    print(f"keypoint disparity error over {len(sequence)} frames:")
    print(f"  per-frame mean (bias) spread: {s[:, 0].min():+.3f} .. "
          f"{s[:, 0].max():+.3f} px, mean {s[:, 0].mean():+.3f}")
    print(f"  rms: mean {s[:, 1].mean():.3f} px   |err|: {s[:, 2].mean():.3f} px")
    return dict(disparity=disp_all, stats=s, render_s=t_render, sgm_s=t_sgm)


if __name__ == "__main__":
    main()
