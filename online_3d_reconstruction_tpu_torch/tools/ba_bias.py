"""The observation residuals of the built BA problem AT GROUND TRUTH (port
of tools/ba_bias.py).

    python -m online_3d_reconstruction_tpu_torch.tools.ba_bias
        [--frames 12] [--sgm] [--ss 2] [--no-subpixel]
        [--device cuda] [--size 384 512 64]

Runs the lab survey through the engine, builds the window's problem
(``ba.device_tracks.build_problem``) and re-solves the landmarks in closed
form under the ground-truth poses (per track, the mean of the world-lifted
observations), so what remains is pure observation error. The mean residual
per keyframe shows a bias shared by a whole frame: the failure that makes
strong observation weights HURT (in ``tools.ate_lab`` the ATE rises as
sigma_pixel falls).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from online_3d_reconstruction_tpu_torch.ba.device_tracks import build_problem
from online_3d_reconstruction_tpu_torch.io import FrameData
from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
    OnlineReconstructor,
    resolve_device,
)
from online_3d_reconstruction_tpu_torch.tools import lab_scene


def residuals_at_ground_truth(problem, live: int, gt_slot: np.ndarray):
    """(res (N, 3), ok (N,), obs_kf (N,), track counts (L,)) of a problem
    whose fields are numpy arrays: each observation's camera-frame residual
    against the landmark re-solved under ``gt_slot``, the (live, 4, 4)
    ground-truth pose of every window slot."""
    ok = np.asarray(problem.obs_valid)
    obs_lm = np.asarray(problem.obs_lm)
    obs_pt = np.asarray(problem.obs_point)
    # obs_kf covers all window slots: clip into the live range (the
    # observations of the others are masked by ``ok`` anyway)
    obs_kf = np.clip(np.asarray(problem.obs_kf), 0, live - 1)
    r_gt = gt_slot[:, :3, :3]
    t_gt = gt_slot[:, :3, 3]

    # world lift at the true poses; the mean per track is the landmark
    world = np.einsum("nij,nj->ni", r_gt[obs_kf], obs_pt) + t_gt[obs_kf]
    l_cap = np.asarray(problem.landmarks).shape[0]
    cnt = np.bincount(obs_lm[ok], minlength=l_cap).astype(np.float64)
    lm = np.zeros((l_cap, 3))
    for a in range(3):
        lm[:, a] = np.bincount(obs_lm[ok], weights=world[ok, a], minlength=l_cap)
    lm /= np.maximum(cnt, 1.0)[:, None]

    res = np.einsum("nji,nj->ni", r_gt[obs_kf], lm[obs_lm] - t_gt[obs_kf]) - obs_pt
    return res, ok, obs_kf, cnt


def main(argv=None, frames: Optional[Sequence[FrameData]] = None) -> dict:
    """``frames``: the survey's frames where the caller has rendered them
    already. Returns the per-axis RMS, the per-slot rows and the track-length
    histogram."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--sgm", action="store_true")
    ap.add_argument("--ss", type=int, default=2,
                    help="render supersampling (2: the anti-aliased camera model)")
    ap.add_argument("--no-subpixel", action="store_true",
                    help="disable subpixel keypoint refinement")
    lab_scene.add_arguments(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    sequence = lab_scene.make_sequence(args.frames, args.size, supersample=args.ss)
    frames = lab_scene.render(sequence, frames)
    gt, _ = lab_scene.ground_truth(frames)
    cfg = lab_scene.base_config(args.size, subpixel=not args.no_subpixel,
                                sync_metrics=False,
                                use_precomputed_disparity=not args.sgm)
    eng = OnlineReconstructor(cfg, sequence.rig, dev)
    for f in frames:
        eng.process(f)

    state = eng._ba_state
    problem, stats = build_problem(state, cfg.ba.max_landmarks)
    live = int(state.count)
    kf_idx = [k.index for k in eng.keyframes[-live:]]
    print(f"window live={live} keyframes={kf_idx} "
          f"landmarks={int(stats['landmarks'])} "
          f"obs={int(stats['observations'])}")

    problem = type(problem)(*(None if v is None else v.cpu().numpy() for v in problem))
    gt_slot = np.stack([gt[kf_idx[s]] for s in range(live)])
    res, ok, obs_kf, cnt = residuals_at_ground_truth(problem, live, gt_slot)
    axis_rms = np.sqrt((res[ok]**2).mean(0))
    print(f"\nobs residual at GT: per-axis RMS "
          f"{axis_rms} (camera frame x,y,z)")
    print(f"{'slot':>4} {'frm':>4} {'nobs':>5}  mean residual (bias)      RMS")
    rows = []
    for s in range(live):
        m = ok & (obs_kf == s)
        if m.sum() == 0:
            continue
        bias = res[m].mean(0)
        rms = np.sqrt((res[m] ** 2).mean(0))
        print(f"{s:>4} {kf_idx[s]:>4} {int(m.sum()):>5} "
              f"[{bias[0]:8.4f} {bias[1]:8.4f} {bias[2]:8.4f}] "
              f"[{rms[0]:7.4f} {rms[1]:7.4f} {rms[2]:7.4f}]")
        rows.append((s, kf_idx[s], int(m.sum()), bias, rms))

    tl = cnt[cnt > 0].astype(int)
    histogram = {int(k): int(v) for k, v in zip(*np.unique(tl, return_counts=True))}
    print(f"\ntrack length histogram: {histogram}")
    return dict(axis_rms=axis_rms, rows=rows, track_lengths=histogram,
                landmarks=int(stats["landmarks"]), observations=int(stats["observations"]))


if __name__ == "__main__":
    main()
