"""Configuration tree for the reconstruction pipeline (the port's own copy of
the reference package's ``config`` module: the same dataclasses, fields and
defaults, so a configuration file written for one reads in the other).

The reference exposes its knobs as hand-parsed ``argv`` flags (frame range,
voxel leaf size, pixel stride, display toggles) plus compiled-in SGBM/ORB
parameters (SURVEY.md §2.1 C1, §5 "Config / flag system"). Here every knob is
a field on a dataclass tree, loadable from YAML/JSON and overridable from the
CLI (``apps/reconstruct.py``).

All shape-determining fields are static Python ints.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class StereoConfig:
    """Rectification + SGM disparity (reference: cv::StereoSGBM params)."""

    height: int = 384
    width: int = 512
    max_disparity: int = 64          # D; multiple of 8 (ideally 64/128 for lanes)
    census_window: Tuple[int, int] = (5, 5)   # census transform window (<=32 bits)
    p1: float = 8.0                  # SGM small-jump penalty (per census-bit cost)
    p2: float = 32.0                 # SGM large-jump penalty
    num_paths: int = 4               # 4 = axis-aligned; 8 adds diagonals
    uniqueness_ratio: float = 0.95   # WTA second-best must exceed best/ratio
    lr_max_diff: int = 1             # left-right consistency threshold (px)
    subpixel: bool = True            # refine around the WTA minimum
    # subpixel interpolator: "parabola" (cv2 SGBM's quadratic) or "vshape"
    # (equiangular/linear fit). Census-style costs rise near-linearly around
    # the true minimum, so the quadratic UNDERSHOOTS the offset — classic
    # pixel-locking toward the WTA integer. Measured at keypoints on the
    # bench scene by the reference: parabola mean bias +0.118 px
    # (frame-correlated, the altitude puts true d ~ 6.67 between integers);
    # vshape cuts it.
    subpixel_fit: str = "vshape"
    speckle_window: int = 50         # max blob size to invalidate (0 = off)
    speckle_range: float = 1.0       # disparity jump that splits a blob
    invalid_value: float = -1.0      # disparity value marking invalid pixels
    use_pallas: bool = True          # the fused aggregation (else the exact scan)
    # storage dtype of the aggregated volume under use_pallas: "bfloat16"
    # (default) rounds the partial totals where the reference's fused kernel
    # does (8-path sums above 256 lose bits; WTA ties may flip on < 0.5% of
    # pixels) and halves the volume's bytes; "float16" rounds at the same
    # points (sums above 2048 lose bits); "float32" is exact. Which one
    # runs: stereo.sgm.aggregation_dtype.
    cost_dtype: str = "bfloat16"


@dataclass(frozen=True)
class FeatureConfig:
    """FAST/ORB-style detection + binary description (reference: cv::cuda::ORB)."""

    max_keypoints: int = 512         # static per-frame keypoint capacity
    # Image-pyramid levels (2x per level). 1 = full-res only: best VO
    # precision at constant altitude (coarse-level matches localize on a
    # 2^l grid and measurably dilute the rigid fit even downweighted);
    # raise to 2-3 for missions with altitude/scale changes, where
    # cross-scale matching keeps tracking alive (see TestPyramid).
    num_levels: int = 1
    fast_threshold: float = 20.0     # FAST-9 intensity threshold (on [0,255])
    fast_arc: int = 9                # contiguous arc length on the 16-px circle
    nms_radius: int = 3              # score non-max suppression radius
    patch_size: int = 31             # orientation / BRIEF sampling patch
    descriptor_bits: int = 256       # rBRIEF length (packed into uint32 words)
    border: int = 20                 # keypoint exclusion border (sampling safety)
    grid_tiles: Tuple[int, int] = (4, 4)  # spatial top-k tiles for even coverage
    seed: int = 7                    # BRIEF sampling-pattern RNG seed
    # Subpixel corner localization: per-axis parabola fit on the detector's
    # own (ungated) FAST excess-score surface (features/fast.
    # refine_subpixel_score). Integer detections carry a frame-correlated
    # +-0.5 px quantization that was the measured dominant BA observation
    # error; the score-surface fit removes it translation-equivariantly
    # (a gradient-centroid cornerSubPix solve measurably does NOT on dense
    # natural texture — see refine_subpixel_score's docstring).
    subpixel: bool = True


@dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching (reference: brute-force Hamming; ours: Hamming distance matrix top-k)."""

    max_hamming: int = 64            # absolute Hamming acceptance threshold
    ratio: float = 0.9               # Lowe ratio: best < ratio * second-best
    cross_check: bool = True         # mutual nearest-neighbour consistency


@dataclass(frozen=True)
class OdometryConfig:
    """3D-3D rigid pose correction (reference: SVD/Umeyama fit with gating)."""

    ransac_iters: int = 128          # fixed-iteration vmapped RANSAC hypotheses
    ransac_threshold: float = 0.25   # inlier distance (metres)
    min_inliers: int = 12            # fitness gate: fall back to prior below this
    min_matches: int = 12            # matches required to attempt correction
    max_point_depth: float = 80.0    # Z cull for lifted feature points (metres)
    depth_edge_threshold: float = 1.5  # reject keypoints on disparity edges (px)
    # Link-fit regularization (odometry/rigid.refine_rigid_gn): the
    # flight-log relative-attitude prior constrains the tilt modes a
    # near-planar nadir scene cannot (tilt ~ lateral shift * altitude — the
    # measured ~0.1 m/link VO error source); weight = 1/sigma^2 for the
    # relative attitude noise (sqrt(2) * 0.01 rad per-pose -> ~5000).
    rot_prior_weight: float = 5000.0
    # relative information of the z residual component in the link fit
    # (stereo z noise is ~3x lateral and correlated; 0 < w <= 1)
    depth_rel_weight: float = 0.2
    # valid-masked box pre-averaging of the disparity map before keypoint
    # lifts (frontend.lift_keypoints_to_3d): radius r -> (2r+1)^2 window.
    # A point sample carries the full per-pixel SGM noise into every
    # observation; the local mean respects a smooth surface. 0 = off.
    disparity_smooth_radius: int = 2
    seed: int = 0


@dataclass(frozen=True)
class BAConfig:
    """Sliding-window local bundle adjustment (reference: sparse CPU BA;
    ours: dense-block Schur complement)."""

    # Window size and landmark capacity MUST scale together: a W-frame
    # window over K keypoints holds far more than K multi-observation
    # tracks, and a saturated capacity silently drops observations —
    # measured to make W > 8 windows WORSE until L followed (the bench runs
    # W=24/L=2048, ATE 0.469x prior-only).
    window: int = 16                 # keyframe poses in the local window
    max_landmarks: int = 1024        # static landmark capacity per solve
    max_obs: int = 8192              # static observation capacity per solve
    gn_iters: int = 3                # damped Gauss-Newton iterations (3 is
                                     # ATE-identical to 5 on the bench scene
                                     # at 60% of the solve cost)
    damping: float = 1e-4            # Levenberg-Marquardt lambda
    huber_delta: float = 0.5         # robust loss width, in units of the
                                     # residual norm: metres when
                                     # obs_weighting is off (default), sigmas
                                     # when on (~3 is the classical knee)
    # anisotropic stereo observation weighting (opt-in): each 3D observation
    # gets a full 3x3 information matrix from the stereo noise model
    # (ba.problem.stereo_obs_information) with sigma_z = z^2 sigma_d /
    # (fx b) and sigma_xy = z sigma_px / fx plus the ray x/y<->z coupling.
    # With SUBPIXEL feature localization (features.subpixel, the default)
    # this is the bench's winning estimator: full-stack ATE 0.469x
    # prior-only. It requires honest sigmas
    # and VO-gated track links — in the integer-pixel era the correlated
    # quantization bias made it WORSE than isotropic, which is why it
    # remains opt-in for the library default.
    obs_weighting: bool = False
    # measured noise sigmas for the subpixel feature + SGM chain
    # (the reference's measurement: keypoint-level disparity rms 0.27 px with a
    # frame-correlated bias sigma_d=1.0 absorbs; ba_bias: lateral ~0.2 px)
    sigma_disparity: float = 1.0     # 1-sigma disparity noise (px)
    sigma_pixel: float = 0.5         # 1-sigma keypoint localization noise (px)
    anchor_first: bool = True        # gauge fix: freeze the first pose in window
                                     # (ignored when both prior weights > 0 —
                                     # absolute priors then fix the gauge)
    # absolute flight-log prior terms (GPS-aided BA): 1/sigma^2 information
    # weights. The absolute-translation mode of the window is observable ONLY
    # through these, so even weak priors bound drift; strong priors would
    # inject the (independent) per-record GPS noise into the *relative* poses
    # the visual terms measure far better. Defaults assume ~1 m / ~0.1 rad
    # effective confidence; 0 disables (anchor_first then fixes the gauge).
    prior_position_weight: float = 1.0
    prior_rotation_weight: float = 100.0


@dataclass(frozen=True)
class MappingConfig:
    """Global map fusion + voxel downsampling (reference: pcl::VoxelGrid)."""

    voxel_size: float = 0.25         # leaf size (metres)
    map_capacity: int = 2_000_000    # static global voxel-point capacity
    frame_point_stride: int = 2      # pixel subsample stride ("jump pixels")
    # color plane stride (0 = frame_point_stride). Color is cosmetic — the
    # voxel filter averages it over >= 4-point leaves anyway — while the
    # packed color plane is ~27% of the per-frame host->device upload; a
    # coarser color stride (must be a multiple of frame_point_stride) buys
    # wire bandwidth on links where the upload bounds the streamed rate.
    color_stride: int = 0
    fuse_every: int = 1              # fuse every k-th frame's cloud
    downsample_every: int = 8        # re-voxelize the global pool every k frames
    min_depth: float = 0.5           # Z culling band for backprojected points
    max_depth: float = 60.0
    bounds: float = 2048.0           # |x|,|y|,|z| world bound for voxel keys


@dataclass(frozen=True)
class RuntimeConfig:
    """Online loop, keyframes, checkpointing, metrics (reference: main loop)."""

    keyframe_translation: float = 1.0    # new keyframe if moved this far (m)
    keyframe_rotation: float = 0.26      # ... or rotated this much (rad)
    keyframe_min_gap: int = 1            # min frames between keyframes
    ba_every_keyframe: bool = True       # run local BA on each new keyframe
    host_ba: bool = False                # True: host track-table BA (ba/window.py)
                                         # False: on-device window (ba/device_tracks.py)
    checkpoint_every: int = 0            # keyframes between snapshots (0 = off)
    checkpoint_dir: str = "checkpoints"
    metrics_path: str = ""               # JSONL stage-metrics sink ("" = off)
    sync_metrics: bool = True            # False: defer VO scalar pulls to finish()
    prefetch_depth: int = 2              # host->device double buffering depth
    use_precomputed_disparity: bool = False  # offline mode: consume
                                         # FrameData.disparity, skip SGM (C5)
    profile: bool = False                # torch.profiler trace around stages
    debug_nans: bool = False             # non-finite check after each stage


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration: one object drives the whole engine."""

    stereo: StereoConfig = field(default_factory=StereoConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    matching: MatchConfig = field(default_factory=MatchConfig)
    odometry: OdometryConfig = field(default_factory=OdometryConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


_SECTIONS = {
    "stereo": StereoConfig,
    "features": FeatureConfig,
    "matching": MatchConfig,
    "odometry": OdometryConfig,
    "ba": BAConfig,
    "mapping": MappingConfig,
    "runtime": RuntimeConfig,
}


def _coerce(cls, value):
    """Build a (possibly nested) dataclass from a plain dict, tuple-ifying lists."""
    if not isinstance(value, dict):
        return value
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in value.items():
        if key not in hints:
            raise KeyError(f"unknown config key {cls.__name__}.{key}")
        if isinstance(val, list):
            val = tuple(val)
        kwargs[key] = val
    return cls(**kwargs)


def config_from_dict(data: Dict[str, Any]) -> PipelineConfig:
    """A ``PipelineConfig`` from plain data: the inverse of ``config_to_dict``
    (also of the reference package's, whose sections and fields are the same)."""
    sections = {}
    for name, cls in _SECTIONS.items():
        if name in data:
            sections[name] = _coerce(cls, data[name])
    extra = set(data) - set(_SECTIONS)
    if extra:
        raise KeyError(f"unknown config sections: {sorted(extra)}")
    return PipelineConfig(**sections)


def config_to_dict(cfg: PipelineConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


