"""The lab scene: the one scene, rig, trajectory, prior noise and base
configuration that the estimator tools share (``tools.ate_lab``,
``ate_diag``, ``vo_link_err``, ``ba_bias``, ``sgm_cache``,
``bias_vs_edge``; the block the reference repeats in each of them).

A 384x512 stereo rig (fx = fy = 400, baseline 0.5 m; identity maps, or
with ``distorted`` the raw lens model rectified in the pipeline) surveys a
textured ground plane with one 8 m plateau from 30 m at 1.2 m a frame; the
flight-log priors carry 0.15 m / 0.01 rad of noise. At another ``--size``
the focal length scales with the width, so the view stays the same.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from online_3d_reconstruction_tpu_torch.config import (
    BAConfig,
    FeatureConfig,
    MappingConfig,
    OdometryConfig,
    PipelineConfig,
    RuntimeConfig,
    StereoConfig,
)
from online_3d_reconstruction_tpu_torch.io import (
    CameraIntrinsics,
    FrameData,
    Plateau,
    StereoCalibration,
    SyntheticScene,
    SyntheticSequence,
    identity_rig,
    make_survey_trajectory,
    stereo_rectify,
)

SIZE = (384, 512, 64)            # height, width, disparity range
PRIOR_T_SIGMA = 0.15             # m
PRIOR_R_SIGMA = 0.01             # rad
MAX_KEYPOINTS = 512
FAST_THRESHOLD = 5.0             # of 255


def add_arguments(parser: argparse.ArgumentParser) -> None:
    """The arguments every lab tool takes beside the reference's own."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--size", type=int, nargs=3, default=SIZE,
                        metavar=("HEIGHT", "WIDTH", "DISPARITY"))


def make_sequence(n_frames: int, size: Sequence[int] = SIZE, supersample: int = 2,
                  distorted: bool = False) -> SyntheticSequence:
    """The lab survey as a render-on-demand sequence; its ``rig`` is the
    rectified rig and its ``calib`` the raw calibration (None for the
    identity rig)."""
    h, w = int(size[0]), int(size[1])
    fx = 400.0 * w / 512.0
    calib = None
    if distorted:
        cam = CameraIntrinsics(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h,
                               dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
        calib = StereoCalibration(left=cam, right=cam,
                                  translation=np.array([-0.5, 0.0, 0.0]))
        rig = stereo_rectify(calib)
    else:
        rig = identity_rig(fx=fx, fy=fx, cx=w / 2, cy=h / 2, baseline=0.5,
                           width=w, height=h)
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                           supersample=supersample)
    poses = make_survey_trajectory(n_frames, altitude=30.0, speed=1.2)
    return SyntheticSequence(scene=scene, rig=rig, poses=poses,
                             prior_translation_sigma=PRIOR_T_SIGMA,
                             prior_rotation_sigma=PRIOR_R_SIGMA, calib=calib)


def render(sequence: SyntheticSequence,
           frames: Optional[Sequence[FrameData]] = None) -> List[FrameData]:
    """Every frame of ``sequence``. ``frames`` are frames of the same scene
    that the caller rendered already (a longer survey's first frames are a
    shorter survey's): they are taken instead of rendering, after a check
    of their size and ground-truth poses."""
    n = len(sequence)
    if frames is None:
        return [sequence[i] for i in range(n)]
    if len(frames) < n:
        raise ValueError(f"{len(frames)} rendered frames given, {n} needed")
    shape = (sequence.rig.height, sequence.rig.width)
    for i, frame in enumerate(frames[:n]):
        if frame.left.shape != shape or not np.allclose(frame.gt_pose, sequence.poses[i],
                                                        atol=1e-5):
            raise ValueError(f"rendered frame {i} is not frame {i} of the lab survey")
    return list(frames[:n])


def base_config(size: Sequence[int] = SIZE, ba: Optional[BAConfig] = None,
                subpixel: bool = True, **runtime) -> PipelineConfig:
    """The tools' configuration: 8-path SGM, 512 FAST keypoints at threshold
    5, RANSAC at 0.5 m, priors weighted by their 1/sigma^2, 0.25 m voxels in
    a 2M-point map at stride 2, a keyframe every 0.5 m; ``runtime`` sets
    fields of ``RuntimeConfig``."""
    h, w, d = (int(v) for v in size)
    if ba is None:
        ba = BAConfig(prior_position_weight=1.0 / PRIOR_T_SIGMA**2,
                      prior_rotation_weight=1.0 / PRIOR_R_SIGMA**2)
    return PipelineConfig(
        stereo=StereoConfig(height=h, width=w, max_disparity=d, num_paths=8),
        features=FeatureConfig(max_keypoints=MAX_KEYPOINTS, fast_threshold=FAST_THRESHOLD,
                               subpixel=subpixel),
        odometry=OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        ba=ba,
        mapping=MappingConfig(voxel_size=0.25, map_capacity=2_000_000,
                              frame_point_stride=2, min_depth=1.0, max_depth=60.0),
        runtime=RuntimeConfig(keyframe_translation=0.5, **runtime),
    )


def ground_truth(frames: Sequence[FrameData]) -> Tuple[np.ndarray, np.ndarray]:
    """(ground-truth poses, flight-log priors), each (N, 4, 4)."""
    return (np.stack([f.gt_pose for f in frames]),
            np.stack([f.prior_pose for f in frames]))
