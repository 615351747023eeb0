"""ATE lab: the estimator's quality on the lab scene under different window
BA settings (port of tools/ate_lab.py).

    python -m online_3d_reconstruction_tpu_torch.tools.ate_lab
        [--sgm | --sgm-cache build/sgm_cache.npz] [--frames 32] [--ss 2]
        [--distorted] [--variants NAME [NAME ...]]
        [--device cuda] [--size 384 512 64]

Runs the lab survey (``tools.lab_scene``) through ``OnlineReconstructor``
in offline mode on the scene's exact disparity, which isolates the
estimator from the stereo quality, and prints the full-stack ATE of every
variant beside prior-only dead reckoning (target: full stack <= 0.5x).
``--sgm`` runs SGM on every frame instead (on a card: the aggregation and
run-total kernels); ``--sgm-cache`` sweeps the variants against real SGM
maps computed once (``tools.sgm_cache`` writes the same file).

The variants are the sweep that chose the product's window BA settings:
the keypoint disparity error measured by ``tools.sgm_cache`` and the
keypoint localization measured by ``tools.ba_bias`` are about half the
(0.5, 0.5) px constants of the first variant, and 512 landmarks saturate a
window of many frames over 512 keypoints, so ``build_problem`` drops
observations and larger windows make the ATE worse until L grows with W.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.config import BAConfig
from online_3d_reconstruction_tpu_torch.io import FrameData
from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
    OnlineReconstructor,
    resolve_device,
)
from online_3d_reconstruction_tpu_torch.stereo.sgm import sgm_disparity
from online_3d_reconstruction_tpu_torch.tools import lab_scene
from online_3d_reconstruction_tpu_torch.utils.metrics import ate_rmse


def variants(base: BAConfig) -> Dict[str, BAConfig]:
    """The named window-BA settings of the sweep, over ``base`` with the
    stereo noise model and a 3-sigma huber on."""
    w = dataclasses.replace(base, obs_weighting=True, huber_delta=3.0)

    def v(sigma_disparity, window=None, max_landmarks=None, **kw):
        if window is not None:
            kw.update(window=window, max_landmarks=max_landmarks)
        return dataclasses.replace(w, sigma_pixel=0.5, sigma_disparity=sigma_disparity, **kw)

    return {
        "w bench W8 L512": v(0.5),
        "w W16 L2048": v(0.5, 16, 2048),
        "w W24 L4096": v(0.5, 24, 4096),
        "w W24 L4096 d1.0": v(1.0, 24, 4096),
        "w W24 L4096 d1.5": v(1.5, 24, 4096),
        "w W32 L4096": v(0.5, 32, 4096),
        # cheaper solves at the winning estimator point
        "w W24 L4096 d1.0 gn3": v(1.0, 24, 4096, gn_iters=3),
        "w W24 L3072 d1.0": v(1.0, 24, 3072),
        "w W24 L2048 d1.0": v(1.0, 24, 2048),
        "w W16 L2048 d1.0": v(1.0, 16, 2048),
    }


def run(cfg, rig, frames, device):
    eng = OnlineReconstructor(cfg, rig, device)
    for f in frames:
        eng.process(f)
    return eng.finish()


def main(argv=None, frames: Optional[Sequence[FrameData]] = None) -> dict:
    """``frames``: the survey's frames where the caller has rendered them
    already. Returns {"prior": prior-only ATE, "ate": {variant: ATE}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sgm", action="store_true",
                    help="run SGM on every frame instead of the exact disparity")
    ap.add_argument("--sgm-cache", default="",
                    help="NPZ path: compute the SGM disparities once, then sweep "
                         "the variants against the cached maps in offline mode "
                         "(real stereo noise without SGM in every variant)")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--ss", type=int, default=2,
                    help="render supersampling (2: the anti-aliased camera model)")
    ap.add_argument("--distorted", action="store_true",
                    help="the raw distorted render, rectified in the pipeline, "
                         "instead of the identity rig: what the rectification "
                         "chain costs in ATE")
    ap.add_argument("--variants", nargs="+", metavar="NAME",
                    help="run only these of the named variants")
    lab_scene.add_arguments(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = lab_scene.base_config(args.size, sync_metrics=False,
                                 use_precomputed_disparity=not args.sgm)
    sweep = variants(base.ba)
    unknown = [name for name in args.variants or () if name not in sweep]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; the sweep has {list(sweep)}")

    sequence = lab_scene.make_sequence(args.frames, args.size, supersample=args.ss,
                                       distorted=args.distorted)
    rig = sequence.rig
    frames = lab_scene.render(sequence, frames)
    if args.sgm_cache:
        if os.path.exists(args.sgm_cache):
            disp_all = np.load(args.sgm_cache)["disparity"]
            if len(disp_all) < len(frames) or disp_all.shape[1:] != frames[0].left.shape:
                raise ValueError(f"{args.sgm_cache} holds {disp_all.shape} maps, the "
                                 f"run needs {(len(frames), *frames[0].left.shape)}")
        else:
            maps = []
            for i, f in enumerate(frames):
                dd, _ = sgm_disparity(torch.as_tensor(f.left, device=dev),
                                      torch.as_tensor(f.right, device=dev), base.stereo)
                maps.append(dd.cpu().numpy())
                print(f"  sgm {i + 1}/{len(frames)}", flush=True)
            disp_all = np.stack(maps)
            np.savez_compressed(args.sgm_cache, disparity=disp_all)
        frames = [f._replace(disparity=disp_all[i]) for i, f in enumerate(frames)]
    gt, priors = lab_scene.ground_truth(frames)
    ate_prior = ate_rmse(priors, gt)
    print(f"prior-only ATE: {ate_prior:.4f} m  (target full <= "
          f"{0.5 * ate_prior:.4f})", flush=True)

    ates = {}
    for name, ba in sweep.items():
        if args.variants and name not in args.variants:
            continue
        res = run(base.replace(ba=ba), rig, frames, dev)
        ates[name] = ate = ate_rmse(res.trajectory, gt)
        print(f"{name:28s}: ATE {ate:.4f} m  ({ate / ate_prior:.2f}x prior)",
              flush=True)
    return dict(prior=ate_prior, ate=ates)


if __name__ == "__main__":
    main()
