"""Sliding-window BA with a host track table (port of ba/window.py).

The host keeps the track bookkeeping (per-keyframe landmark ids,
observation lists) in numpy, and every solve packs a fixed-capacity
``BAProblem`` on the device for the dense-Schur Gauss-Newton. Capacities
come from BAConfig (window, max_landmarks, max_obs); overflow is counted
and reported, never silently reshaped. This is the ``runtime.host_ba``
path; the default keyframe event is ba/device_tracks.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.ba.problem import (
    BAProblem,
    stereo_obs_information,
)
from online_3d_reconstruction_tpu_torch.ba.schur import solve_ba
from online_3d_reconstruction_tpu_torch.config import BAConfig


class _KfRecord:
    def __init__(self, index: int, points3d: np.ndarray, valid3d: np.ndarray,
                 pose: np.ndarray):
        self.index = index
        self.points3d = points3d          # (K, 3) camera-frame lifts
        self.valid3d = valid3d            # (K,)
        self.pose = pose                  # (4, 4) current world estimate
        self.lm_of_kp = np.full(len(valid3d), -1, dtype=np.int64)


class WindowBA:
    """Track table + fixed-capacity window solves on ``device``.

    ``solver`` defaults to the single-device dense-Schur ``solve_ba``; pass
    ``functools.partial(parallel.solve_ba_sharded, mesh=mesh)`` (the same
    keywords) for the observation-sharded multi-rank solve."""

    def __init__(self, config: BAConfig, solver=None, noise_model=None,
                 device: "torch.device | str" = "cuda"):
        self.cfg = config
        self.solver = solver or solve_ba
        # ba.problem.StereoNoiseModel for the full 3x3 observation
        # information; None = unit weights
        self.noise_model = noise_model
        self.device = torch.device(device)
        self.keyframes: List[_KfRecord] = []
        self._next_lm = 0
        self.last_stats: Dict = {}

    def add_keyframe(self, index: int, points3d: np.ndarray, valid3d: np.ndarray,
                     pose: np.ndarray, match_index: Optional[np.ndarray] = None,
                     match_valid: Optional[np.ndarray] = None) -> None:
        """Register a keyframe; link tracks via its matches to the previous
        one. match_index/match_valid: the odometry matcher's output — per
        current keypoint, the previous keyframe's keypoint index and
        acceptance mask."""
        rec = _KfRecord(index, np.asarray(points3d), np.asarray(valid3d),
                        np.asarray(pose))
        if self.keyframes and match_index is not None:
            prev = self.keyframes[-1]
            m_idx = np.asarray(match_index)
            ok = np.asarray(match_valid) & rec.valid3d & prev.valid3d[m_idx]
            for i in np.nonzero(ok)[0]:
                j = int(m_idx[i])
                lm = prev.lm_of_kp[j]
                if lm < 0:
                    lm = self._next_lm
                    self._next_lm += 1
                    prev.lm_of_kp[j] = lm
                rec.lm_of_kp[i] = lm
        self.keyframes.append(rec)
        if len(self.keyframes) > 4 * self.cfg.window:
            # drop ancient keyframes the window can never touch again
            self.keyframes = self.keyframes[-2 * self.cfg.window:]

    def solve_window(self) -> Optional[List[np.ndarray]]:
        """Refine the last ``window`` keyframe poses; returns them (or None).

        Landmarks observed fewer than twice inside the window contribute no
        inter-pose constraint and are dropped.
        """
        window = self.keyframes[-self.cfg.window:]
        if len(window) < 2:
            return None
        w_count = len(window)
        w_cap = self.cfg.window  # static pose capacity

        lm_count: Dict[int, int] = {}
        for rec in window:
            for lm in rec.lm_of_kp[rec.lm_of_kp >= 0]:
                lm_count[int(lm)] = lm_count.get(int(lm), 0) + 1
        shared = {lm for lm, c in lm_count.items() if c >= 2}
        if len(shared) < 3:
            self.last_stats = {"landmarks": len(shared), "skipped": True}
            return None

        lm_order = sorted(shared)
        dropped_lm = 0
        if len(lm_order) > self.cfg.max_landmarks:
            dropped_lm = len(lm_order) - self.cfg.max_landmarks
            lm_order = lm_order[: self.cfg.max_landmarks]

        remap_table = np.full(self._next_lm or 1, -1, dtype=np.int64)
        remap_table[np.asarray(lm_order, dtype=np.int64)] = np.arange(len(lm_order))
        obs_kf_l, obs_lm_l, obs_pt_l = [], [], []
        for k, rec in enumerate(window):
            has_lm = rec.lm_of_kp >= 0
            dense = np.where(has_lm, remap_table[np.clip(rec.lm_of_kp, 0, None)], -1)
            keep = dense >= 0
            obs_kf_l.append(np.full(keep.sum(), k, dtype=np.int64))
            obs_lm_l.append(dense[keep])
            obs_pt_l.append(rec.points3d[keep])
        obs_kf = np.concatenate(obs_kf_l)
        obs_lm = np.concatenate(obs_lm_l)
        obs_pt = np.concatenate(obs_pt_l).astype(np.float32)
        n_obs = len(obs_kf)
        dropped_obs = max(0, n_obs - self.cfg.max_obs)
        n_use = min(n_obs, self.cfg.max_obs)

        # pad poses to the window capacity (identity poses, no obs): their
        # Schur blocks are pure damping, the update stays exactly zero
        poses0 = np.tile(np.eye(4, dtype=np.float32), (w_cap, 1, 1))
        poses0[:w_count] = np.stack([rec.pose for rec in window]).astype(np.float32)
        obs_kf_a = np.zeros(self.cfg.max_obs, dtype=np.int64)
        obs_lm_a = np.zeros(self.cfg.max_obs, dtype=np.int64)
        obs_pt_a = np.zeros((self.cfg.max_obs, 3), dtype=np.float32)
        obs_ok_a = np.zeros(self.cfg.max_obs, dtype=bool)
        obs_kf_a[:n_use] = obs_kf[:n_use]
        obs_lm_a[:n_use] = obs_lm[:n_use]
        obs_pt_a[:n_use] = obs_pt[:n_use]
        obs_ok_a[:n_use] = True

        # landmark init: mean of world-lifted observations under current poses
        l_cap = self.cfg.max_landmarks
        world = (np.einsum("nij,nj->ni", poses0[obs_kf_a[:n_use], :3, :3],
                           obs_pt_a[:n_use])
                 + poses0[obs_kf_a[:n_use], :3, 3])
        lm_init = np.zeros((l_cap, 3), dtype=np.float32)
        lm_cnt = np.zeros(l_cap, dtype=np.float32)
        np.add.at(lm_init, obs_lm_a[:n_use], world)
        np.add.at(lm_cnt, obs_lm_a[:n_use], 1.0)
        lm_valid = lm_cnt > 0
        lm_init[lm_valid] /= lm_cnt[lm_valid, None]

        def t(a):
            return torch.from_numpy(a).to(self.device)

        obs_point = t(obs_pt_a)
        obs_weight = None
        if self.noise_model is not None:
            obs_weight = stereo_obs_information(obs_point, self.noise_model)
        problem = BAProblem(
            poses=t(poses0), landmarks=t(lm_init), lm_valid=t(lm_valid),
            obs_kf=t(obs_kf_a), obs_lm=t(obs_lm_a), obs_point=obs_point,
            obs_valid=t(obs_ok_a), obs_weight=obs_weight)
        poses_ref, _, cost_trace = self.solver(
            problem, iters=self.cfg.gn_iters, damping=self.cfg.damping,
            huber_delta=self.cfg.huber_delta, anchor_first=self.cfg.anchor_first)
        poses_np = poses_ref.cpu().numpy()[:w_count]
        trace = cost_trace.cpu().numpy()
        for rec, pose in zip(window, poses_np):
            rec.pose = pose
        self.last_stats = {
            "landmarks": len(lm_order),
            "observations": n_use,
            "dropped_landmarks": dropped_lm,
            "dropped_observations": dropped_obs,
            "cost_initial": float(trace[0]),
            "cost_final": float(trace[-1]),
            "window": w_count,
        }
        return [p for p in poses_np]
