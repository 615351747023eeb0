"""Visual-odometry front end: features -> matches -> 3D-3D pose correction
(port of odometry/frontend.py)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .config import FeatureConfig, MatchConfig, OdometryConfig
from .brief import Keypoints, detect_and_describe
from .match import match_descriptors
from . import se3
from . import rigid


class FrameFeatures(NamedTuple):
    """Per-frame odometry state: keypoints + their camera-frame 3D lifts."""

    keypoints: Keypoints
    points3d: torch.Tensor   # (K, 3) float32 camera-frame points
    valid3d: torch.Tensor    # (K,) bool — keypoint has a usable depth


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over the zero-padded (2r+1)^2 window around each pixel."""
    win = 2 * radius + 1
    h, w = x.shape
    p = F.pad(x, (radius, radius, radius, radius))
    rows = p[0:h]
    for i in range(1, win):
        rows = rows + p[i:i + h]
    out = rows[:, 0:w]
    for i in range(1, win):
        out = out + rows[:, i:i + w]
    return out


def lift_keypoints_to_3d(xy: torch.Tensor, disparity: torch.Tensor,
                         q: torch.Tensor, max_depth: float = 80.0,
                         min_depth: float = 0.1, edge_threshold: float = 1.5,
                         smooth_radius: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lift (K, 2) pixel coords to camera-frame 3D through the disparity map.

    The disparity is sampled bilinearly (nearest pixel when a corner is
    invalid), optionally after a valid-masked box average of radius
    ``smooth_radius``; keypoints whose 2 px neighbours in the raw map differ
    by more than ``edge_threshold`` (or are invalid) are rejected.
    Returns ((K, 3) points, (K,) valid).
    """
    h, w = disparity.shape
    u = torch.round(xy[:, 0]).to(torch.int64).clamp(0, w - 1)
    v = torch.round(xy[:, 1]).to(torch.int64).clamp(0, h - 1)
    raw = disparity
    if smooth_radius > 0:
        ok_px = (disparity > 0).to(torch.float32)
        num = _box_sum(disparity * ok_px, smooth_radius)
        den = _box_sum(ok_px, smooth_radius)
        smoothed = num / torch.clamp(den, min=1.0)
        disparity = torch.where((den > 0) & (disparity > 0), smoothed, disparity)
    d_nearest = disparity[v, u]

    xf = xy[:, 0].clamp(0.0, w - 1.0)
    yf = xy[:, 1].clamp(0.0, h - 1.0)
    x0 = torch.floor(xf).to(torch.int64).clamp(0, w - 2)
    y0 = torch.floor(yf).to(torch.int64).clamp(0, h - 2)
    tx = xf - x0.to(torch.float32)
    ty = yf - y0.to(torch.float32)
    d00 = disparity[y0, x0]
    d10 = disparity[y0, x0 + 1]
    d01 = disparity[y0 + 1, x0]
    d11 = disparity[y0 + 1, x0 + 1]
    corners_ok = (d00 > 0) & (d10 > 0) & (d01 > 0) & (d11 > 0)
    d_bilin = ((1 - ty) * ((1 - tx) * d00 + tx * d10)
               + ty * ((1 - tx) * d01 + tx * d11))
    d = torch.where(corners_ok, d_bilin, d_nearest)

    on_edge = torch.zeros_like(d, dtype=torch.bool)
    if edge_threshold > 0:
        d_raw = raw[v, u]
        for du, dv in ((2, 0), (-2, 0), (0, 2), (0, -2)):
            d_nb = raw[(v + dv).clamp(0, h - 1), (u + du).clamp(0, w - 1)]
            on_edge |= ((d_nb - d_raw).abs() > edge_threshold) | (d_nb <= 0.0)
    uvd1 = torch.stack([xy[:, 0], xy[:, 1], d, torch.ones_like(d)], dim=-1)
    xyzw = uvd1 @ q.to(torch.float32).t()
    w_coord = xyzw[:, 3]
    safe_w = torch.where(w_coord.abs() > 1e-12, w_coord, 1e-12)
    pts = xyzw[:, :3] / safe_w[:, None]
    z = pts[:, 2]
    ok = (d > 0.0) & (z > min_depth) & (z < max_depth) & torch.isfinite(z) & ~on_edge
    return torch.where(ok[:, None], pts, 0.0), ok


def extract_frame_features(left: torch.Tensor, disparity: torch.Tensor,
                           q: torch.Tensor, feat_cfg: FeatureConfig,
                           odo_cfg: OdometryConfig) -> FrameFeatures:
    """Detect + describe + lift: everything odometry keeps per keyframe."""
    kp = detect_and_describe(left, feat_cfg)
    pts, ok = lift_keypoints_to_3d(
        kp.xy, disparity, q,
        max_depth=odo_cfg.max_point_depth,
        edge_threshold=odo_cfg.depth_edge_threshold,
        smooth_radius=odo_cfg.disparity_smooth_radius,
    )
    return FrameFeatures(keypoints=kp, points3d=pts, valid3d=ok & kp.valid)


def odometry_step(curr: FrameFeatures, prev: FrameFeatures,
                  prior_rel: torch.Tensor, samples: torch.Tensor,
                  match_cfg: MatchConfig, odo_cfg: OdometryConfig):
    """One pose-correction step against the previous keyframe.

    prior_rel: (4, 4) flight-log relative pose (prev-camera <- curr-camera),
    the fallback when the visual fit fails its gate; samples: RANSAC
    hypothesis indices (``rigid.hypothesis_indices``: the reference's draw
    from the PRNG key it takes here). Returns (rel (4, 4), used_vo (), inlier_count (),
    matches), where the exported match validity is gated on geometric
    consistency and on the fit succeeding (window BA links tracks through
    these matches; see the reference's comment at this gate).
    """
    matches = match_descriptors(
        curr.keypoints.descriptors, prev.keypoints.descriptors,
        curr.keypoints.valid, prev.keypoints.valid,
        max_hamming=match_cfg.max_hamming, ratio=match_cfg.ratio,
        cross_check=match_cfg.cross_check,
    )
    src = curr.points3d
    dst = prev.points3d[matches.index]
    pair_ok = matches.valid & curr.valid3d & prev.valid3d[matches.index]
    pair_octave = torch.maximum(curr.keypoints.octave,
                                prev.keypoints.octave[matches.index])
    pair_weight = 0.25 ** pair_octave.to(torch.float32)

    enough = pair_ok.sum() >= odo_cfg.min_matches
    t_vo, inlier_mask, count, fit_ok = rigid.ransac_rigid(
        src, dst, pair_ok, samples,
        threshold=odo_cfg.ransac_threshold,
        min_inliers=odo_cfg.min_inliers,
        weights=pair_weight,
        rot_prior=prior_rel[:3, :3],
        rot_prior_weight=odo_cfg.rot_prior_weight,
        depth_rel_weight=odo_cfg.depth_rel_weight,
    )
    used_vo = fit_ok & enough
    rel = torch.where(used_vo, t_vo, prior_rel)
    ba_valid = matches.valid & inlier_mask & used_vo
    return rel, used_vo, count, matches._replace(valid=ba_valid)


def compose_world_pose(pose_prev: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """World pose of the current frame from the previous world pose and the
    (prev-camera <- curr-camera) relative transform."""
    return se3.compose(pose_prev, rel)


def tracking_step(curr: FrameFeatures, prev: FrameFeatures,
                  kf_pose: torch.Tensor, kf_prior: torch.Tensor,
                  prior: torch.Tensor, frame_idx,
                  match_cfg: MatchConfig, odo_cfg: OdometryConfig):
    """The per-frame tracking update: prior-relative pose inv(kf_prior) @
    prior, this frame's RANSAC draw (the reference's ``fold_in`` of
    ``frame_idx`` into the key of ``odo_cfg.seed``, made on the device;
    ``frame_idx`` is a 0-dim integer tensor, as ``unpack_frame`` reads it
    from the packed header, or an int), the VO step, and the world pose
    kf_pose @ rel. Returns (pose (4, 4), used_vo (), inliers (), matches)."""
    prior_rel = se3.compose(se3.inverse(kf_prior), prior)
    samples = rigid.hypothesis_indices(odo_cfg.seed, frame_idx,
                                       odo_cfg.ransac_iters,
                                       curr.points3d.shape[0],
                                       curr.points3d.device)
    rel, used_vo, count, matches = odometry_step(curr, prev, prior_rel, samples,
                                                 match_cfg, odo_cfg)
    return compose_world_pose(kf_pose, rel), used_vo, count, matches
