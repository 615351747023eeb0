"""ATE diagnosis: the per-frame error of the full stack on the lab scene
(port of tools/ate_diag.py).

    python -m online_3d_reconstruction_tpu_torch.tools.ate_diag
        [--frames 32] [--sgm] [--device cuda] [--size 384 512 64]

Where does the full-stack trajectory's residual error come from, when an
optimal fusion of the window's independent GPS priors through rigid vision
links should do better? Prints per frame |t_err| beside the prior's, the
health of VO (``used_vo``, inliers) and the keyframe flag, then the ATE of
the full stack, of the priors and of a one-shot oracle: a sliding-window
least-squares fuse of all priors with the exact relative poses (the
information bound for this class of estimator), and the rotation RMS.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np

from online_3d_reconstruction_tpu_torch.io import FrameData
from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
    OnlineReconstructor,
    resolve_device,
)
from online_3d_reconstruction_tpu_torch.tools import lab_scene
from online_3d_reconstruction_tpu_torch.utils.metrics import ate_rmse


def oracle_fuse(priors: np.ndarray, gt: np.ndarray, window: int,
                kf_frames: Optional[List[int]] = None) -> np.ndarray:
    """Information bound: a sliding-window fuse of the prior translations
    under PERFECT relative poses (no vision noise). Each keyframe's estimate
    is gt_k + the mean of (prior_i - gt_i) over the window in which it is
    the oldest, the last solve that touched it. ``kf_frames`` lists the
    frames that became keyframes (windows slide over keyframes, not
    frames); the others inherit the window of the keyframe before them."""
    n = len(priors)
    kf = sorted(kf_frames) if kf_frames else list(range(n))
    err = priors[:, :3, 3] - gt[:, :3, 3]
    out = gt.copy()
    for k in range(n):
        # position of k's governing keyframe in the keyframe sequence
        pos = max(0, np.searchsorted(kf, k, side="right") - 1)
        idx = [kf[i] for i in range(pos, min(pos + window, len(kf)))]
        out[k, :3, 3] = gt[k, :3, 3] + err[idx].mean(axis=0)
    return out


def main(argv=None, frames: Optional[Sequence[FrameData]] = None) -> dict:
    """``frames``: the survey's frames (rendered WITHOUT supersampling, as
    this tool renders them) where the caller has them already. Returns the
    table's rows and the summary numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--sgm", action="store_true")
    lab_scene.add_arguments(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    sequence = lab_scene.make_sequence(args.frames, args.size, supersample=1)
    frames = lab_scene.render(sequence, frames)
    gt, priors = lab_scene.ground_truth(frames)
    cfg = lab_scene.base_config(args.size, sync_metrics=True,
                                use_precomputed_disparity=not args.sgm)
    eng = OnlineReconstructor(cfg, sequence.rig, dev)
    recs = [eng.process(f) for f in frames]
    traj = eng.finish().trajectory

    print(f"{'frm':>3} {'kf':>2} {'vo':>3} {'inl':>4} "
          f"{'|terr|':>7} {'|terr_prior|':>12}")
    rows = []
    for k, r in enumerate(recs):
        te = np.linalg.norm(traj[k, :3, 3] - gt[k, :3, 3])
        tp = np.linalg.norm(priors[k, :3, 3] - gt[k, :3, 3])
        print(f"{k:>3} {int(bool(r.get('keyframe'))):>2} "
              f"{str(r.get('used_vo')):>3} {str(r.get('vo_inliers')):>4} "
              f"{te:7.3f} {tp:12.3f}")
        rows.append((k, bool(r.get("keyframe")), r.get("used_vo"), r.get("vo_inliers"),
                     float(te), float(tp)))

    ate_full = ate_rmse(traj, gt)
    ate_prior = ate_rmse(priors, gt)
    kf_frames = [k for k, r in enumerate(recs) if r.get("keyframe")]
    ate_oracle = ate_rmse(oracle_fuse(priors, gt, cfg.ba.window, kf_frames), gt)
    # rotation error of the estimate (deg RMS)
    rel = np.einsum("kij,kil->kjl", traj[:, :3, :3], gt[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    rot_rms = float(np.sqrt((ang**2).mean()))
    print(f"\nATE full {ate_full:.4f}  prior {ate_prior:.4f} "
          f"(ratio {ate_full/ate_prior:.2f})  oracle(W={cfg.ba.window}) "
          f"{ate_oracle:.4f}  rot RMS {rot_rms:.3f} deg")
    return dict(rows=rows, trajectory=traj, ate_full=ate_full, ate_prior=ate_prior,
                ate_oracle=ate_oracle, rot_rms_deg=rot_rms)


if __name__ == "__main__":
    main()
