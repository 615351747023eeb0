"""Where does the keypoint disparity bias live? Bias against the distance
to the nearest true disparity edge, from a cached SGM run (port of
tools/bias_vs_edge.py).

    python -m online_3d_reconstruction_tpu_torch.tools.bias_vs_edge
        [build/sgm_cache.npz] [--device cuda] [--size 384 512 64]

If the bias concentrates within a few pixels of the ground truth's
disparity discontinuities it is SGM foreground fattening leaking past the
lift's +-2 px edge gate; if it is uniform it is an artifact of matching or
aggregation. The cache is ``tools.sgm_cache``'s NPZ (identity rig); its
first 12 frames are read.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from online_3d_reconstruction_tpu_torch.io import FrameData
from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
from online_3d_reconstruction_tpu_torch.tools import lab_scene
from online_3d_reconstruction_tpu_torch.tools.sgm_cache import keypoint_pixels

BINS = ((0, 3), (3, 6), (6, 12), (12, 1 << 30))   # px to the nearest edge


def main(argv=None, frames: Optional[Sequence[FrameData]] = None) -> list:
    """``frames``: the survey's frames where the caller has rendered them
    already. Returns one (lo, hi, n, mean, rms) per distance bin."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cache", nargs="?", default=os.path.join("build", "sgm_cache.npz"))
    lab_scene.add_arguments(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w, _ = args.size
    disp_all = np.load(args.cache)["disparity"]
    n_frames = min(12, len(disp_all))
    if disp_all.shape[1:] != (h, w):
        raise ValueError(f"{args.cache} holds {disp_all.shape[1:]} maps, --size says {(h, w)}")
    # the survey's poses and priors do not depend on its length
    scene_frames = lab_scene.render(lab_scene.make_sequence(n_frames, args.size), frames)

    errs = {b: [] for b in BINS}
    for f, dd in zip(scene_frames, disp_all):
        gtd = np.asarray(f.disparity)
        u, v = keypoint_pixels(torch.as_tensor(f.left, device=dev), h, w)
        # distance to the nearest ground-truth disparity edge (> 0.75 px jump)
        gx = np.abs(np.diff(gtd, axis=1, prepend=gtd[:, :1]))
        gy = np.abs(np.diff(gtd, axis=0, prepend=gtd[:1]))
        dist = distance_transform_edt(~(np.maximum(gx, gy) > 0.75))
        d_sgm, d_gt, d_edge = dd[v, u], gtd[v, u], dist[v, u]
        ok = (d_sgm > 0) & (d_gt > 0)
        err = d_sgm - d_gt
        for lo, hi in BINS:
            errs[(lo, hi)].append(err[ok & (d_edge >= lo) & (d_edge < hi)])

    print(f"{n_frames} frames, bias by distance-to-GT-disparity-edge:")
    rows = []
    for lo, hi in BINS:
        e = np.concatenate(errs[(lo, hi)])
        # an empty bin (a small frame has no keypoint that far from an edge)
        mean, rms = (e.mean(), np.sqrt((e**2).mean())) if len(e) else (np.nan, np.nan)
        print(f"  {lo:3d}..{min(hi, 999):3d} px: n={len(e):5d}  "
              f"mean {mean:+.3f}  rms {rms:.3f}")
        rows.append((lo, hi, len(e), float(mean), float(rms)))
    return rows


if __name__ == "__main__":
    main()
