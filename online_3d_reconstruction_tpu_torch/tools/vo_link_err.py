"""The error of every VO link on the lab scene (port of
tools/vo_link_err.py).

    python -m online_3d_reconstruction_tpu_torch.tools.vo_link_err
        [--frames 24] [--sgm] [--device cuda] [--size 384 512 64]

If the VO relatives between consecutive keyframes are accurate to
centimetres, the ATE gap is the weighting and the window structure of BA;
if they are off by ~0.1 m, the vision front end itself (detection,
matching, lift) is the limiter. Window BA is off, so pose_k = pose_{k-1}
composed with the VO relative and the error of a link is the difference of
two consecutive absolute errors. The prior fallback stays on: its use
shows as ``used_vo`` False.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from online_3d_reconstruction_tpu_torch.config import BAConfig
from online_3d_reconstruction_tpu_torch.io import FrameData
from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
    OnlineReconstructor,
    resolve_device,
)
from online_3d_reconstruction_tpu_torch.tools import lab_scene


def main(argv=None, frames: Optional[Sequence[FrameData]] = None) -> dict:
    """``frames``: the survey's frames (rendered WITHOUT supersampling, as
    this tool renders them) where the caller has them already. Returns the
    per-link translation errors (N - 1, 3), rotation errors in degrees, and
    the summary numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--sgm", action="store_true")
    lab_scene.add_arguments(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    sequence = lab_scene.make_sequence(args.frames, args.size, supersample=1)
    frames = lab_scene.render(sequence, frames)
    gt, _ = lab_scene.ground_truth(frames)
    cfg = lab_scene.base_config(args.size, ba=BAConfig(), sync_metrics=True,
                                ba_every_keyframe=False, host_ba=False,
                                use_precomputed_disparity=not args.sgm)
    eng = OnlineReconstructor(cfg, sequence.rig, dev)
    recs = [eng.process(f) for f in frames]
    traj = eng.finish().trajectory

    print(f"{'lnk':>3} {'vo':>3} {'inl':>4} {'|dt_err|':>9} "
          f"{'dxyz_err':>27} {'drot_deg':>8}")
    errs, angles = [], []
    for k in range(1, len(frames)):
        # the estimated relative between consecutive frames against the true one
        rel_est = np.linalg.inv(traj[k - 1]) @ traj[k]
        rel_gt = np.linalg.inv(gt[k - 1]) @ gt[k]
        d_ = np.linalg.inv(rel_gt) @ rel_est
        dt = d_[:3, 3]
        ang = np.degrees(np.arccos(np.clip((np.trace(d_[:3, :3]) - 1) / 2, -1, 1)))
        errs.append(dt)
        angles.append(float(ang))
        r = recs[k]
        print(f"{k:>3} {str(r.get('used_vo')):>3} {str(r.get('vo_inliers')):>4}"
              f" {np.linalg.norm(dt):9.4f} "
              f"[{dt[0]:8.4f} {dt[1]:8.4f} {dt[2]:8.4f}] {ang:8.4f}")
    errs = np.asarray(errs)
    rms = float(np.sqrt((errs**2).sum(1).mean()))
    print(f"\nper-link dt RMS: {rms:.4f} m, "
          f"per-axis RMS {np.sqrt((errs**2).mean(0))}, "
          f"mean bias {errs.mean(0)}")
    return dict(link_errors=errs, link_angles_deg=np.asarray(angles), rms=rms,
                axis_rms=np.sqrt((errs**2).mean(0)), bias=errs.mean(0),
                used_vo=[r.get("used_vo") for r in recs[1:]])


if __name__ == "__main__":
    main()
