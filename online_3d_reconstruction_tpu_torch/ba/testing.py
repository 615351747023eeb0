"""Synthetic bundle problems with known optimum (port of ba/testing.py).

Nadir-ish cameras over scattered ground landmarks, exact observations
(optionally noised), poses and landmarks perturbed away from the optimum
(first pose anchored). The numpy ``rng`` draws are the reference's, in the
same order, so a seed gives the same problem up to the f32 rounding of the
pose perturbation.
"""

from __future__ import annotations

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.ba.problem import BAProblem
from online_3d_reconstruction_tpu_torch.geometry import se3


def make_synthetic_bundle(rng, w=4, l=32, pose_noise=0.05, lm_noise=0.05,
                          obs_noise=0.0, n_cap=None, obs_per_kf=None,
                          device: "torch.device | str" = "cuda"):
    """Returns (BAProblem on ``device``, gt_poses (w, 4, 4), gt_landmarks
    (l, 3)) — the last two numpy.

    Observations are slot-major (all of keyframe 0, then keyframe 1, ...).
    ``obs_per_kf`` limits each keyframe to a random landmark subset; with
    ``n_cap = w * obs_per_kf`` the problem satisfies the
    ``slot_major=obs_per_kf`` layout of ba/schur.
    """
    gt_poses = []
    for k in range(w):
        pose = np.eye(4)
        pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
        pose[:3, 3] = [2.0 * k, 0.3 * k, 10.0 + 0.1 * k]
        gt_poses.append(pose)
    gt_poses = np.stack(gt_poses).astype(np.float32)
    gt_lms = np.stack(
        [rng.uniform(-4, 2 * w + 4, l), rng.uniform(-5, 5, l), rng.uniform(0, 1.5, l)],
        axis=1,
    ).astype(np.float32)

    obs_kf, obs_lm, obs_pt = [], [], []
    for k in range(w):
        inv = np.linalg.inv(gt_poses[k])
        if obs_per_kf is not None and obs_per_kf < l:
            lm_ids = np.sort(rng.choice(l, obs_per_kf, replace=False))
        else:
            lm_ids = np.arange(l)
        for j in lm_ids:
            p = inv[:3, :3] @ gt_lms[j] + inv[:3, 3]
            if obs_noise > 0:
                p = p + rng.normal(0, obs_noise, 3)
            obs_kf.append(k)
            obs_lm.append(int(j))
            obs_pt.append(p)
    n = len(obs_kf)
    cap = n_cap or n

    noisy_poses = gt_poses.copy()
    for k in range(1, w):
        xi = np.concatenate(
            [rng.normal(0, pose_noise, 3), rng.normal(0, pose_noise / 2, 3)])
        noisy_poses[k] = se3.retract(torch.from_numpy(gt_poses[k]),
                                     torch.from_numpy(xi.astype(np.float32))).numpy()
    noisy_lms = gt_lms + rng.normal(0, lm_noise, gt_lms.shape).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    problem = BAProblem(
        poses=t(noisy_poses),
        landmarks=t(noisy_lms),
        lm_valid=t(np.ones(l, dtype=bool)),
        obs_kf=t(np.resize(obs_kf, cap).astype(np.int64)),
        obs_lm=t(np.resize(obs_lm, cap).astype(np.int64)),
        obs_point=t(np.resize(np.asarray(obs_pt, np.float32), (cap, 3))),
        obs_valid=t(np.arange(cap) < n),
    )
    return problem, gt_poses, gt_lms
