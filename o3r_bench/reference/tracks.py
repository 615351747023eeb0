"""On-device sliding-window BA: track building + solve without the host
(port of ba/device_tracks.py).

The keyframe window lives on the device as a fixed-shape ring
(``WindowState``), and a keyframe event (``keyframe_core``):

1. shifts the ring and appends the new keyframe (points, validity, the
   matcher's index/valid link to the previous keyframe, pose, prior);
2. builds landmark tracks from the match chains: each keypoint's root is
   the chain start id, so a landmark is exactly a maximal match chain;
3. densifies landmark ids by a stable sort of the roots and run lengths,
   drops single-observation landmarks, caps at the landmark capacity
   (overflow counted, never hidden);
4. initializes landmarks at the mean of their world-lifted observations;
5. runs the dense-block Schur Gauss-Newton (ba/schur.py) and writes the
   refined poses back into the ring.

The host never waits for the device: the number of live slots is a 0-dim
device tensor, as the reference's ``count``, the shift of a full window is
a masked select, and every data-dependent choice is a device tensor. So one
keyframe event has the same launches at every fill level, and a CUDA graph
captured once holds it (runtime/step_graph.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .problem import (
    BAProblem,
    stereo_obs_information,
)
from .schur import solve_ba
from .config import BAConfig

_SENTINEL = 2**63 - 1


class WindowState(NamedTuple):
    """Device keyframe window (slot 0 oldest .. count-1 newest)."""

    points3d: torch.Tensor   # (W, K, 3) camera-frame keypoint lifts
    valid3d: torch.Tensor    # (W, K) bool
    match_idx: torch.Tensor  # (W, K) int64 — link into slot k-1's keypoints
    match_ok: torch.Tensor   # (W, K) bool — link valid (slot 0: all False)
    poses: torch.Tensor      # (W, 4, 4) world-from-camera (identity when empty)
    priors: torch.Tensor     # (W, 4, 4) flight-log priors
    count: torch.Tensor      # () int64 live slots


def create_window(window: int, max_keypoints: int,
                  device: "torch.device | str") -> WindowState:
    w, k = window, max_keypoints
    eye = torch.eye(4, dtype=torch.float32, device=device).repeat(w, 1, 1)
    return WindowState(
        points3d=torch.zeros((w, k, 3), dtype=torch.float32, device=device),
        valid3d=torch.zeros((w, k), dtype=torch.bool, device=device),
        match_idx=torch.zeros((w, k), dtype=torch.int64, device=device),
        match_ok=torch.zeros((w, k), dtype=torch.bool, device=device),
        poses=eye,
        priors=eye.clone(),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def _append(state: WindowState, points3d, valid3d, match_idx, match_ok,
            pose, prior) -> WindowState:
    """Shift-if-full + write the new keyframe at slot min(count, W-1), as
    masked selects on the device (no branch on the count). Returns a new
    state; the given one is left as it was."""
    w = state.poses.shape[0]
    full = state.count >= w

    def shifted(a, sever=False):
        rolled = torch.roll(a, -1, dims=0)
        if sever:  # the new slot 0's link pointed at the dropped keyframe
            rolled[0] = False
        return torch.where(full.reshape((1,) * a.dim()), rolled, a)

    at = torch.clamp(state.count, max=w - 1)
    slot = torch.arange(w, device=at.device) == at
    valid_s = shifted(state.valid3d)
    # a track link only counts when both endpoints have usable 3D lifts;
    # slot 0 never links backward
    match_idx = match_idx.to(torch.int64)
    prev_valid = torch.index_select(valid_s, 0, torch.clamp(at - 1, min=0).reshape(1))[0]
    link_ok = match_ok & valid3d & prev_valid[match_idx] & (at > 0)

    def put(a, row):
        return torch.where(slot.reshape((w,) + (1,) * (a.dim() - 1)), row[None], a)

    return WindowState(
        points3d=put(shifted(state.points3d), points3d),
        valid3d=put(valid_s, valid3d),
        match_idx=put(shifted(state.match_idx), match_idx),
        match_ok=put(shifted(state.match_ok, sever=True), link_ok),
        poses=put(shifted(state.poses), pose),
        priors=put(shifted(state.priors), prior),
        count=at + 1)


def _chain_roots(match_idx: torch.Tensor, match_ok: torch.Tensor) -> torch.Tensor:
    """(W, K) int64 — per keypoint, the flat id (slot*K + kp) of its chain
    start. A keypoint with no valid link to the previous slot starts a
    chain."""
    w, k = match_idx.shape
    own = (torch.arange(w, device=match_idx.device)[:, None] * k
           + torch.arange(k, device=match_idx.device)[None, :])
    roots = []
    prev = own[0]
    for s in range(w):
        prev = torch.where(match_ok[s], prev[match_idx[s]], own[s])
        roots.append(prev)
    return torch.stack(roots)


def build_problem(state: WindowState, max_landmarks: int,
                  noise_model=None) -> Tuple[BAProblem, dict]:
    """Pack the window into a fixed-capacity BAProblem (device code only).

    Landmark = maximal match chain with >= 2 valid 3D observations inside
    the live window. ``noise_model`` (a ba.problem.StereoNoiseModel) enables
    the full 3x3 per-observation information. Returns (problem, stats),
    stats holding device scalars {landmarks, observations,
    dropped_landmarks}.
    """
    w, k = state.valid3d.shape
    n = w * k
    l_cap = max_landmarks
    dev = state.valid3d.device

    slot = torch.arange(w, device=dev)
    live = slot < state.count                                  # (W,)
    obs_ok = (state.valid3d & live[:, None]).reshape(n)
    roots = _chain_roots(state.match_idx, state.match_ok).reshape(n)

    # dense landmark ids: a stable sort of the roots (invalid observations
    # last), run lengths by counting each run's members, and ids numbered
    # in sorted order over the runs that keep >= 2 observations
    keyed = torch.where(obs_ok, roots, _SENTINEL)
    sorted_r, order = torch.sort(keyed, stable=True)
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = sorted_r[1:] != sorted_r[:-1]
    run = torch.cumsum(is_new.to(torch.int64), 0) - 1
    run_count = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, run, torch.ones(n, dtype=torch.int64, device=dev))
    keep_pos = (run_count[run] >= 2) & (sorted_r != _SENTINEL)
    first_kept = is_new & keep_pos
    new_id = torch.cumsum(first_kept.to(torch.int64), 0) - 1
    lm_sorted = torch.where(keep_pos, new_id, -1)
    lm_flat = torch.empty_like(lm_sorted)
    lm_flat[order] = lm_sorted                                  # inverse permutation

    n_lm = first_kept.sum()
    dropped_lm = torch.clamp(n_lm - l_cap, min=0)
    obs_valid = obs_ok & (lm_flat >= 0) & (lm_flat < l_cap)
    obs_lm = torch.clamp(lm_flat, 0, l_cap - 1)
    obs_kf = slot.repeat_interleave(k)
    obs_pt = state.points3d.reshape(n, 3)

    # landmark init: mean world lift under the current poses. Each (landmark,
    # slot) pair takes one observation (the matcher's cross check makes a
    # chain visit a slot once), so the scatter below writes each target once
    # and the sum over slots is a plain reduction: deterministic on CUDA.
    world = (torch.einsum("wij,wkj->wki", state.poses[:, :3, :3], state.points3d)
             + state.poses[:, None, :3, 3]).reshape(n, 3)
    okf = obs_valid.to(torch.float32)
    per_slot = torch.zeros((l_cap * w, 4), dtype=torch.float32, device=dev)
    per_slot.index_add_(0, obs_lm * w + obs_kf,
                        torch.cat([world * okf[:, None], okf[:, None]], dim=1))
    sums = per_slot.reshape(l_cap, w, 4).sum(1)
    lm_cnt = sums[:, 3]
    lm_valid = lm_cnt > 0
    lm_init = sums[:, :3] / torch.clamp(lm_cnt, min=1.0)[:, None]

    obs_weight = None
    if noise_model is not None:
        obs_weight = stereo_obs_information(obs_pt, noise_model)

    problem = BAProblem(
        poses=state.poses, landmarks=lm_init, lm_valid=lm_valid,
        obs_kf=obs_kf, obs_lm=obs_lm, obs_point=obs_pt, obs_valid=obs_valid,
        priors=state.priors, prior_valid=live, obs_weight=obs_weight)
    stats = {
        "landmarks": torch.clamp(n_lm, max=l_cap),
        "observations": obs_valid.sum(),
        "dropped_landmarks": dropped_lm,
    }
    return problem, stats


def keyframe_core(state: WindowState, points3d: torch.Tensor,
                  valid3d: torch.Tensor, match_idx: torch.Tensor,
                  match_ok: torch.Tensor, pose: torch.Tensor,
                  prior: torch.Tensor, cfg: BAConfig, noise_model=None
                  ) -> Tuple[WindowState, torch.Tensor, dict]:
    """Append a keyframe and refine the window.

    Returns (new state, refined poses (W, 4, 4) aligned with the window
    slots, stats dict of device scalars). With fewer than 2 live keyframes
    there are no co-observed landmarks and the solve leaves the poses as
    they are (the prior terms alone are already at their optimum for a
    pose equal to its prior).
    """
    state = _append(state, points3d, valid3d, match_idx, match_ok, pose, prior)
    problem, stats = build_problem(state, cfg.max_landmarks, noise_model)
    # absolute priors on position AND rotation fix the gauge; the hard
    # first-pose anchor would pin the window to its own dead-reckoned
    # drift, so it only applies when priors are off
    full_priors = cfg.prior_position_weight > 0 and cfg.prior_rotation_weight > 0
    solve_kw = dict(
        iters=cfg.gn_iters, damping=cfg.damping, huber_delta=cfg.huber_delta,
        anchor_first=cfg.anchor_first and not full_priors,
        prior_position_weight=cfg.prior_position_weight,
        prior_rotation_weight=cfg.prior_rotation_weight)
    # the window's observation list is slot-major by construction
    poses_ref, _, cost_trace = solve_ba(
        problem, slot_major=state.valid3d.shape[1], **solve_kw)
    # only live slots move; empty slots keep identity for the next append
    live = (torch.arange(state.poses.shape[0], device=poses_ref.device)
            < state.count)[:, None, None]
    poses_new = torch.where(live, poses_ref, state.poses)
    state = state._replace(poses=poses_new)
    stats = dict(stats, cost_initial=cost_trace[0], cost_final=cost_trace[-1])
    return state, poses_new, stats
