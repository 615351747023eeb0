"""The comparison that decides ``correct``.

After the window the harness hands over what the program produced, as host
arrays (``RunOutputs``): every frame's pose, the refined window of the
sampled keyframe events and of the events before them, the features the
engine kept for the keyframes in those windows, the staging pool (the
frames since the last flush, as world points) and the main map at the
window's close, and the map ``finish`` returned. The plain reference
(``reference/``) works each stage out again from the benchmark's own
frames and the configuration:

- stereo and features: every keyframe of a sampled window, rectified,
  SGM (at the configuration's storage), WTA/LR, speckle filter, FAST/BRIEF
  and lifts; compared keypoint slot by slot (``feature_mismatch``);
- matching, tracking and window BA: a sampled keyframe event is rebuilt
  from the reference's features, its matches to the keyframe before, the
  frame's tracked pose and the priors, starting from the program's refined
  window of the event before (the program's state: the reference follows
  it event by event), and solved; its refined window, and the tracked
  poses of sampled frames that are no keyframe, against the program's
  (``pose_gap_m``, ``pose_gap_rad``);
- the cloud: each staged frame backprojected and moved to the world at the
  program's pose, against the staging pool slot by slot
  (``cloud_mismatch``);
- the voxel map: the main map at the close, with the reference's staged
  clouds flushed into it and the whole downsampled, against ``finish``'s
  map voxel by voxel (``map_mismatch``).

A slot, keypoint or voxel mismatches where its validity differs or where a
coordinate differs by more than ``tolerance`` (a fraction of the voxel).
Each number is held against its limit from the configuration file.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from o3r_bench.reference.backproject import PointCloud
from o3r_bench.reference.frame import ReferenceFrames
from o3r_bench.reference.frontend import FrameFeatures
from o3r_bench.reference.voxel import voxel_coords, voxel_downsample

NUMBERS = ("feature_mismatch", "pose_gap_m", "pose_gap_rad", "cloud_mismatch",
           "map_mismatch")


@dataclass
class Plan:
    """What the check compares: keyframe ordinals of the sampled events,
    sampled frames that are no keyframe, and the keyframe frames whose
    features and events the harness has to keep."""

    events: List[int]
    frames: List[int]
    kf_frames: List[int]
    needed_events: List[int] = field(default_factory=list)


@dataclass
class RunOutputs:
    """The program's outputs after the window, on the host."""

    step_poses: np.ndarray                  # (N, 4, 4) every frame's pose
    kf_frames: List[int]                    # frame index of each keyframe
    events: Dict[int, np.ndarray]           # keyframe ordinal -> refined (W, 4, 4)
    features: Dict[int, Dict[str, np.ndarray]]  # keyframe frame -> its features
    staged_frames: List[int]                # frames in the staging pool, in order
    staging: Dict[str, np.ndarray]          # points, colors, valid
    main_map: Dict[str, np.ndarray]         # points, colors, valid at the close
    final_map: Tuple[np.ndarray, np.ndarray]  # finish()'s points, colors


def make_plan(seed: int, kf_frames: Sequence[int], n_frames: int, first: int,
              window: int, n_events: int, n_frames_sampled: int) -> Plan:
    """The last keyframe event, ``n_events - 1`` more drawn from the seed
    among the keyframes of the window (frames ``first`` ..), and
    ``n_frames_sampled`` frames drawn among the window's frames that are
    no keyframe."""
    rng = np.random.default_rng([seed, 2])
    ordinals = [o for o, f in enumerate(kf_frames) if f >= first and o >= 1]
    events = [ordinals[-1]] if ordinals else []
    rest = ordinals[:-1]
    if rest and n_events > 1:
        events += sorted(rng.choice(rest, size=min(n_events - 1, len(rest)),
                                    replace=False).tolist())
    kf_set = set(kf_frames)
    others = [f for f in range(first, n_frames) if f not in kf_set]
    frames = (sorted(rng.choice(others, size=min(n_frames_sampled, len(others)),
                                replace=False).tolist()) if others else [])
    needed = set()
    need_events = set()
    for e in events:
        needed.update(kf_frames[max(0, e - window):e + 1])
        need_events.update((e, e - 1))
    for f in frames:
        needed.add(kf_frames[np.searchsorted(kf_frames, f, side="right") - 1])
    return Plan(events=events, frames=frames, kf_frames=sorted(needed),
                needed_events=sorted(need_events))


def _keypoint_mismatch(prog: Dict[str, np.ndarray], ref: FrameFeatures,
                       tol_m: float) -> Tuple[int, int]:
    """(mismatching slots, slots) of one keyframe's features."""
    kp = ref.keypoints
    r = {"xy": kp.xy, "descriptors": kp.descriptors, "valid": kp.valid,
         "points3d": ref.points3d, "valid3d": ref.valid3d}
    r = {k: v.cpu().numpy() for k, v in r.items()}
    bad = ((prog["valid"] != r["valid"]) | (prog["valid3d"] != r["valid3d"])
           | (np.abs(prog["xy"] - r["xy"]).max(1) > 1e-3)
           | (prog["descriptors"] != r["descriptors"]).any(1))
    both = prog["valid3d"] & r["valid3d"]
    bad |= both & (np.abs(prog["points3d"] - r["points3d"]).max(1) > tol_m)
    return int(bad.sum()), int(bad.size)


def _pose_gap(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """(max translation gap, max rotation angle) between pose stacks."""
    a = np.asarray(a, np.float64).reshape(-1, 4, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4, 4)
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    rel = np.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
    # the angle from both the sine and the cosine: arccos alone reads the
    # rounding of a float32 rotation near 1 as ~1e-3 rad
    cos = (np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0
    sin = 0.5 * np.linalg.norm(np.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
                                         rel[:, 1, 0] - rel[:, 0, 1]], axis=1), axis=1)
    return float(dt.max(initial=0.0)), float(np.arctan2(sin, cos).max(initial=0.0))


def _cloud_mismatch(prog: Dict[str, np.ndarray], ref: PointCloud, tol_m: float):
    pts, cols, valid = (t.cpu().numpy() for t in ref)
    bad = prog["valid"] != valid
    both = prog["valid"] & valid
    bad |= both & ((np.abs(prog["points"] - pts).max(1) > tol_m)
                   | (np.abs(prog["colors"] - cols).max(1) > 1e-3))
    return int(bad.sum()), int(bad.size)


def _map_mismatch(prog_pts, prog_cols, ref: PointCloud, voxel: float, bounds: float,
                  tol_m: float) -> float:
    """Share of the voxels of either map that the other lacks or places
    (or colors) differently."""
    keep = ref.valid.cpu().numpy()
    ref_pts = ref.points.cpu().numpy()[keep]
    ref_cols = ref.colors.cpu().numpy()[keep]

    def keys(pts):
        idx = voxel_coords(torch.from_numpy(np.ascontiguousarray(pts, np.float32)),
                           voxel, bounds).numpy()
        per = int(2.0 * bounds / voxel) + 2
        return (idx[:, 0] * per + idx[:, 1]) * per + idx[:, 2]

    kp, kr = keys(prog_pts), keys(ref_pts)
    common, ip, ir = np.intersect1d(kp, kr, assume_unique=False, return_indices=True)
    union = len(np.union1d(kp, kr))
    differ = ((np.abs(prog_pts[ip] - ref_pts[ir]).max(1) > tol_m)
              | (np.abs(prog_cols[ip] - ref_cols[ir]).max(1) > 1e-3))
    dup = (len(kp) - len(np.unique(kp))) + (len(kr) - len(np.unique(kr)))
    return float((union - len(common) + int(differ.sum()) + dup) / max(union, 1))


def compare(out: RunOutputs, plan: Plan, ref: ReferenceFrames,
            frame: Callable[[int], tuple], tolerance: float) -> Dict[str, float]:
    """The numbers of ``NUMBERS`` for one run. ``frame(i)`` gives stream
    frame i's (left, right, color, prior) as the benchmark made them."""
    cfg = ref.cfg
    dev = ref.device
    tol_m = tolerance * cfg.mapping.voxel_size
    kf_frames = out.kf_frames
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    # stereo and features of every frame the comparison touches
    wanted = sorted(set(plan.kf_frames) | set(plan.frames) | set(out.staged_frames))
    rect = {i: ref.rectified(*frame(i)[:3], first=i == 0) for i in wanted}
    disps = dict(zip(wanted, ref.disparities([rect[i][0] for i in wanted],
                                             [rect[i][1] for i in wanted])))
    feats = {i: ref.features(rect[i][0], disps[i]) for i in set(plan.kf_frames) | set(plan.frames)}

    bad = slots = 0
    for i in plan.kf_frames:
        b, n = _keypoint_mismatch(out.features[i], feats[i], tol_m)
        bad, slots = bad + b, slots + n
    numbers = {"feature_mismatch": bad / max(slots, 1)}

    # tracking and window BA, each event from the program's event before it
    w = cfg.ba.window
    gaps = [(0.0, 0.0)]
    prior = lambda i: t(frame(i)[3])
    pose = lambda i: t(out.step_poses[i])
    for e in plan.events:
        # the window after event e - 1: keyframes lo .. e - 1, the first
        # unlinked (the window's first keyframe, or its link severed)
        lo = max(0, e - w)
        slots_before = []
        for o in range(lo, e):
            f = kf_frames[o]
            matches = None
            if o > lo:
                g = kf_frames[o - 1]
                _, matches = ref.track(feats[f], feats[g], pose(g), prior(g), prior(f), f)
            slots_before.append((feats[f], matches, prior(f)))
        state = ref.window(slots_before, t(out.events[e - 1]))
        f, g = kf_frames[e], kf_frames[e - 1]
        tracked, matches = ref.track(feats[f], feats[g], pose(g), prior(g), prior(f), f)
        refined = ref.ba_event(state, feats[f], matches, tracked, prior(f))
        live = min(e + 1, w)
        gaps.append(_pose_gap(out.events[e][:live], refined[:live].cpu().numpy()))
    for f in plan.frames:
        g = kf_frames[np.searchsorted(kf_frames, f, side="right") - 1]
        tracked, _ = ref.track(feats[f], feats[g], pose(g), prior(g), prior(f), f)
        gaps.append(_pose_gap(out.step_poses[f], tracked.cpu().numpy()))
    numbers["pose_gap_m"] = max(g[0] for g in gaps)
    numbers["pose_gap_rad"] = max(g[1] for g in gaps)

    # the staged clouds, slot by slot, and the map they flush into
    clouds = [ref.world_cloud(disps[i], rect[i][2], pose(i)) for i in out.staged_frames]
    n_staged = sum(c.points.shape[0] for c in clouds)
    if clouds:
        staged = PointCloud(*(torch.cat(parts) for parts in zip(*clouds)))
        prog = {k: v[:n_staged] for k, v in out.staging.items()}
        b, n = _cloud_mismatch(prog, staged, tol_m)
        numbers["cloud_mismatch"] = b / max(n, 1)
        cap = out.staging["valid"].shape[0]
        pad = cap - n_staged
        staged = PointCloud(
            torch.cat([staged.points, torch.zeros((pad, 3), device=dev)]),
            torch.cat([staged.colors, torch.zeros((pad, 3), device=dev)]),
            torch.cat([staged.valid, torch.zeros(pad, dtype=torch.bool, device=dev)]))
        survivors = voxel_downsample(staged, cfg.mapping.voxel_size, cfg.mapping.bounds)
    else:
        numbers["cloud_mismatch"] = 1.0   # nothing staged: nothing the check could see
        survivors = None
    # the flush writes the survivors at the main pool's cursor, clamped so
    # that the staging pool's capacity fits, then the whole pool is reduced
    pool = PointCloud(t(out.main_map["points"]), t(out.main_map["colors"]),
                      torch.as_tensor(out.main_map["valid"], device=dev))
    if survivors is not None:
        cap, s = pool.points.shape[0], survivors.points.shape[0]
        start = min(int(out.main_map["cursor"]), cap - s)
        for dst, src in zip(pool, survivors):
            dst[start:start + s] = src
    final = voxel_downsample(pool, cfg.mapping.voxel_size, cfg.mapping.bounds)
    numbers["map_mismatch"] = _map_mismatch(out.final_map[0], out.final_map[1], final,
                                            cfg.mapping.voxel_size, cfg.mapping.bounds,
                                            tol_m)
    return numbers


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing number fails)."""
    return all(name in numbers and np.isfinite(numbers[name])
               and numbers[name] <= limits[name] for name in limits)
