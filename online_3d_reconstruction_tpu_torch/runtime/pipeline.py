"""The online reconstruction loop (port of runtime/pipeline.py).

Per frame: unpack the uint8 frame buffer, rectify, SGM disparity, FAST/BRIEF
features + 3D lifts, backprojection, tracking against the last keyframe,
and insertion into a staging pool that is voxelized into the main map every
``downsample_every`` frames. On a keyframe, window bundle adjustment runs
inside the same step (``runtime.ba_every_keyframe``, the default): the
device window of ba/device_tracks.py appends the frame, refines the window,
and the frame enters the map at its refined pose; the refined window poses
are patched into the trajectory at ``finish``. ``runtime.host_ba`` selects
the host track table of ba/window.py instead. PyTorch runs eagerly, so the
reference's jitted single-dispatch stages become plain function calls on
the engine's device; the host never waits on the device inside a steady
frame unless ``runtime.sync_metrics`` asks for the VO scalars every frame
(or ``runtime.host_ba`` pulls a keyframe's tracks).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): checkpoints, profiling, the image pyramid, precomputed disparity and
the NaN sanitizer. ``runtime.prefetch_depth`` is ignored: there is no
prefetch thread yet.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.ba.device_tracks import create_window, keyframe_core
from online_3d_reconstruction_tpu_torch.ba.problem import StereoNoiseModel
from online_3d_reconstruction_tpu_torch.ba.window import WindowBA
from online_3d_reconstruction_tpu_torch.config import PipelineConfig
from online_3d_reconstruction_tpu_torch.geometry import se3
from online_3d_reconstruction_tpu_torch.geometry.backproject import (
    PointCloud,
    backproject_disparity,
)
from online_3d_reconstruction_tpu_torch.io import FrameData, RectifiedRig
from online_3d_reconstruction_tpu_torch.mapping.global_map import (
    create_map,
    downsample_map,
    flush_staging,
    insert_cloud,
    map_to_numpy,
)
from online_3d_reconstruction_tpu_torch.odometry.frontend import (
    FrameFeatures,
    extract_frame_features,
    tracking_step,
)
from online_3d_reconstruction_tpu_torch.stereo.rectify import rectify_pair, remap_bilinear
from online_3d_reconstruction_tpu_torch.stereo.sgm import sgm_disparity
from online_3d_reconstruction_tpu_torch.utils.metrics import MetricsLogger, StageTimer

_HEADER_FLOATS = 20      # prior pose (16) + frame index (1) + spare (3)
_HEADER_BYTES = 4 * _HEADER_FLOATS
_INV255 = float(np.float32(1.0 / 255.0))


class ReconstructionResult(NamedTuple):
    trajectory: np.ndarray        # (N, 4, 4) estimated world-from-camera
    keyframe_indices: np.ndarray  # (K,) frame index of each keyframe
    map_points: np.ndarray        # (M, 3)
    map_colors: np.ndarray        # (M, 3)
    metrics: dict                 # summary stats (frames/s, stage means, ...)


class _Keyframe(NamedTuple):
    index: int
    features: FrameFeatures
    pose: torch.Tensor        # (4, 4) world estimate
    prior_pose: torch.Tensor  # (4, 4) flight-log prior at that frame


def resolve_device(device: "torch.device | str") -> torch.device:
    """The engine's device. CUDA must exist if asked for (no fallback to the
    CPU); on CUDA, TF32 is turned off for matmuls and cuDNN, because pose
    products need full f32 (a reduced-precision product cost 0.07x of ATE
    in the reference)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_supported(config: PipelineConfig) -> None:
    """Raise NotImplementedError for configurations the port does not run yet."""
    rt = config.runtime
    missing = [
        (rt.checkpoint_every > 0, "runtime.checkpoint_every>0",
         "prefetch and checkpoint runtime"),
        (rt.profile, "runtime.profile=True", "prefetch and checkpoint runtime"),
        (rt.debug_nans, "runtime.debug_nans=True", "prefetch and checkpoint runtime"),
        (rt.use_precomputed_disparity, "runtime.use_precomputed_disparity=True",
         "pyramid and precomputed-disparity modes"),
        (config.features.num_levels != 1, "features.num_levels>1",
         "pyramid and precomputed-disparity modes"),
    ]
    for bad, what, item in missing:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to PyTorch yet: ROADMAP.md, {item}")


def _color_stride(map_cfg) -> int:
    """Color-plane stride (0 = the point stride); a multiple of the point
    stride so each color texel serves a whole block of points."""
    cs = max(int(map_cfg.frame_point_stride), 1)
    cc = int(map_cfg.color_stride) or cs
    if cc % cs:
        raise ValueError(f"mapping.color_stride ({cc}) must be a multiple of "
                         f"frame_point_stride ({cs})")
    return cc


def pack_frame(frame: FrameData, color_stride: int = 1,
               frame_index: int = 0) -> np.ndarray:
    """One frame as one flat uint8 buffer: an 80-byte float32 header (prior
    pose, frame index) | left gray | right gray | color subsampled by
    ``color_stride``. Gray and color are quantized to 8 bits, as a camera
    delivers them (the reference's layout)."""
    def q8(x):
        return np.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)

    header = np.zeros(_HEADER_FLOATS, dtype=np.float32)
    header[:16] = np.asarray(frame.prior_pose, dtype=np.float32).ravel()
    header[16] = float(frame_index)
    cs = max(int(color_stride), 1)
    return np.concatenate([header.view(np.uint8), q8(frame.left).ravel(),
                           q8(frame.right).ravel(),
                           np.ascontiguousarray(q8(frame.color)[::cs, ::cs]).ravel()])


def unpack_frame(packed: torch.Tensor, h: int, w: int, color_stride: int):
    """Inverse of ``pack_frame`` on the device: (prior (4, 4), left (H, W),
    right (H, W), color (ceil(H/cs), ceil(W/cs), 3)), images in [0, 1]."""
    prior = packed[:_HEADER_BYTES].view(torch.float32)[:16].reshape(4, 4)
    hw = h * w
    off = _HEADER_BYTES
    left = packed[off:off + hw].reshape(h, w).to(torch.float32) * _INV255
    off += hw
    right = packed[off:off + hw].reshape(h, w).to(torch.float32) * _INV255
    off += hw
    hs, ws = -(-h // color_stride), -(-w // color_stride)
    color = packed[off:off + hs * ws * 3].reshape(hs, ws, 3).to(torch.float32) * _INV255
    return prior, left, right, color


class OnlineReconstructor:
    """Streaming engine: feed ``FrameData``, read back trajectory + map."""

    def __init__(self, config: PipelineConfig, rig: RectifiedRig,
                 device: "torch.device | str"):
        check_supported(config)
        self.device = dev = resolve_device(device)
        self.cfg = config
        self.rig = rig
        self.q = torch.as_tensor(np.asarray(rig.q), dtype=torch.float32, device=dev)
        map_left = np.asarray(rig.map_left, dtype=np.float32)
        map_right = np.asarray(rig.map_right, dtype=np.float32)
        mh, mw = map_left.shape[:2]
        gx, gy = np.meshgrid(np.arange(mw, dtype=np.float32),
                             np.arange(mh, dtype=np.float32))
        ident = np.stack([gx, gy], axis=-1)
        # already-rectified input (identity maps): skip the remap
        self._skip_rectify = bool(np.array_equal(map_left, ident)
                                  and np.array_equal(map_right, ident))
        self._cs = max(int(config.mapping.frame_point_stride), 1)
        self._cc = _color_stride(config.mapping)
        self.map_left = torch.as_tensor(map_left, device=dev)
        self.map_right = torch.as_tensor(map_right, device=dev)
        # color travels at its own stride: remap it on the strided grid
        self._color_map = self.map_left[::self._cc, ::self._cc] / float(self._cc)

        self._capacity = config.mapping.map_capacity
        self.gmap = create_map(self._capacity, dev)
        s = self._cs
        self._frame_points = (-(-config.stereo.height // s)
                              * -(-config.stereo.width // s))
        # frames land in a staging pool sized for one flush interval
        flush_frames = max(config.mapping.downsample_every, 1)
        self._staging_cap = min(self._capacity, flush_frames * self._frame_points)
        self._staging = create_map(self._staging_cap, dev)
        self._staged_points = 0
        self._host_cursor = 0
        self._last_kf_prior = np.eye(4)
        self._pending_vo: List = []   # deferred (frame, used_vo, count)
        self.trajectory: List[torch.Tensor] = []
        self.keyframes: List[_Keyframe] = []
        self.frame_idx = 0
        self._frames_since_fuse = 0
        self.metrics = MetricsLogger(config.runtime.metrics_path)
        self._t_start: Optional[float] = None
        # window BA: the device window (default) or the host track table
        self._ba: Optional[WindowBA] = None
        self._ba_state = None
        self._ba_events: List = []   # (keyframe indices, refined (W, 4, 4))
        # the full 3x3 observation information needs the rig's geometry
        self._noise_model = None
        if config.ba.obs_weighting and rig.fx > 0 and rig.baseline > 0:
            self._noise_model = StereoNoiseModel(
                fx=float(rig.fx), fy=float(rig.fy), baseline=float(rig.baseline),
                sigma_px=float(config.ba.sigma_pixel),
                sigma_disparity=float(config.ba.sigma_disparity))
        if config.runtime.ba_every_keyframe:
            if config.runtime.host_ba:
                self._ba = WindowBA(config.ba, noise_model=self._noise_model,
                                    device=dev)
            else:
                k = config.features.max_keypoints
                self._ba_state = create_window(config.ba.window, k, dev)
                self._no_match = (torch.zeros(k, dtype=torch.int64, device=dev),
                                  torch.zeros(k, dtype=torch.bool, device=dev))

    def _is_keyframe(self, prior_np: np.ndarray) -> bool:
        """Motion-threshold policy on the host-side flight-log priors."""
        if not self.keyframes:
            return True
        if self.frame_idx - self.keyframes[-1].index < self.cfg.runtime.keyframe_min_gap:
            return False
        rel = np.linalg.inv(self._last_kf_prior) @ prior_np
        t_err = float(np.linalg.norm(rel[:3, 3]))
        cos_t = np.clip((np.trace(rel[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        r_err = float(np.arccos(cos_t))
        return (t_err > self.cfg.runtime.keyframe_translation
                or r_err > self.cfg.runtime.keyframe_rotation)

    def pack(self, frame: FrameData, frame_index: Optional[int] = None) -> np.ndarray:
        return pack_frame(frame, color_stride=self._cc,
                          frame_index=self.frame_idx if frame_index is None else frame_index)

    def _cloud(self, disp, color_r, prestrided: bool) -> PointCloud:
        m = self.cfg.mapping
        return backproject_disparity(
            disp, color_r, self.q, stride=self._cs, min_depth=m.min_depth,
            max_depth=m.max_depth, invalid_value=self.cfg.stereo.invalid_value,
            color_prestrided=prestrided,
            color_substride=self._cc // self._cs if prestrided else 1)

    def _frame_stage(self, frame: FrameData):
        """First frame, from the float images: rectify -> disparity ->
        features -> camera-frame cloud (full-resolution color)."""
        dev = self.device
        left = torch.as_tensor(frame.left, dtype=torch.float32, device=dev)
        right = torch.as_tensor(frame.right, dtype=torch.float32, device=dev)
        color = torch.as_tensor(frame.color, dtype=torch.float32, device=dev)
        if self._skip_rectify:
            left_r, right_r, color_r = left, right, color
        else:
            left_r, right_r = rectify_pair(left, right, self.map_left, self.map_right)
            color_r = remap_bilinear(color, self.map_left)
        disp, _ = sgm_disparity(left_r, right_r, self.cfg.stereo)
        feats = extract_frame_features(left_r, disp, self.q, self.cfg.features,
                                       self.cfg.odometry)
        return feats, self._cloud(disp, color_r, prestrided=False)

    def _steady_step(self, packed, kf: _Keyframe, fuse: bool, ba_event: bool):
        """A steady frame: unpack -> rectify -> disparity -> features ->
        cloud -> tracking [-> window BA] -> insert into the staging pool.
        With ``ba_event`` the frame is a keyframe: the device window appends
        it and refines, and the frame's pose is its refined one (the
        reference's ``_steady_step_kf``). Returns (pose, prior, feats,
        used_vo, inlier_count, matches, refined window poses or None)."""
        cfg = self.cfg
        packed = torch.as_tensor(packed).to(self.device)
        prior, left, right, color = unpack_frame(
            packed, cfg.stereo.height, cfg.stereo.width, self._cc)
        if self._skip_rectify:
            left_r, right_r, color_r = left, right, color
        else:
            left_r, right_r = rectify_pair(left, right, self.map_left, self.map_right)
            color_r = remap_bilinear(color, self._color_map)
        disp, _ = sgm_disparity(left_r, right_r, cfg.stereo)
        feats = extract_frame_features(left_r, disp, self.q, cfg.features, cfg.odometry)
        cloud = self._cloud(disp, color_r, prestrided=True)
        pose, used_vo, count, matches = tracking_step(
            feats, kf.features, kf.pose, kf.prior_pose, prior, self.frame_idx,
            cfg.matching, cfg.odometry)
        refined = None
        if ba_event:
            self._ba_state, refined, _ = keyframe_core(
                self._ba_state, feats.points3d, feats.valid3d, matches.index,
                matches.valid, pose, prior, cfg.ba, noise_model=self._noise_model)
            pose = refined[self._ba_state.count - 1]
        if fuse:
            insert_cloud(self._staging, PointCloud(
                se3.transform_points(pose, cloud.points), cloud.colors, cloud.valid))
        return pose, prior, feats, used_vo, count, matches, refined

    def process(self, frame: FrameData) -> dict:
        """Run one frame through the pipeline; returns its metrics record."""
        if self._t_start is None:
            self._t_start = time.perf_counter()
        timer = StageTimer()
        cfg = self.cfg
        used_vo: object = False
        inliers: object = 0
        matches = None
        refined = None
        fuse = self._frames_since_fuse + 1 >= cfg.mapping.fuse_every
        # the keyframe policy reads only host-side priors, so the host knows
        # before the step whether this frame's window BA runs inside it
        is_kf = self._is_keyframe(frame.prior_pose)
        if not self.keyframes:
            # first frame: anchor the world to the prior (no tracking target)
            prior = torch.as_tensor(frame.prior_pose, dtype=torch.float32,
                                    device=self.device)
            with timer.stage("frame_compute"):
                feats, cloud = self._frame_stage(frame)
            pose = prior
            if fuse:
                with timer.stage("fusion"):
                    insert_cloud(self._staging, PointCloud(
                        se3.transform_points(pose, cloud.points), cloud.colors,
                        cloud.valid))
        else:
            with timer.stage("step"):
                (pose, prior, feats, used_vo_t, count, matches,
                 refined) = self._steady_step(self.pack(frame), self.keyframes[-1],
                                              fuse, is_kf and self._ba_state is not None)
                if cfg.runtime.sync_metrics:
                    used_vo = bool(used_vo_t)   # waits for the device
                    inliers = int(count)
                else:
                    self._pending_vo.append((self.frame_idx, used_vo_t, count))
                    used_vo, inliers = None, None
        self.trajectory.append(pose)

        if is_kf:
            self._last_kf_prior = np.asarray(frame.prior_pose, dtype=np.float64)
            self.keyframes.append(_Keyframe(index=self.frame_idx, features=feats,
                                            pose=pose, prior_pose=prior))
            if self._ba_state is not None:
                with timer.stage("ba"):
                    live = min(len(self.keyframes), cfg.ba.window)
                    if refined is None:
                        # first keyframe: no step ran BA, append it alone
                        m_idx, m_ok = ((matches.index, matches.valid)
                                       if matches is not None else self._no_match)
                        self._ba_state, refined, _ = keyframe_core(
                            self._ba_state, feats.points3d, feats.valid3d, m_idx,
                            m_ok, pose, prior, cfg.ba, noise_model=self._noise_model)
                        # the newest slot's refined pose seeds the next tracking
                        self.keyframes[-1] = self.keyframes[-1]._replace(
                            pose=refined[live - 1])
                    # trajectory entries are patched in bulk at finish()
                    self._ba_events.append(
                        ([k.index for k in self.keyframes[-live:]], refined))
            elif self._ba is not None:
                with timer.stage("ba"):
                    self._ba.add_keyframe(
                        index=self.frame_idx,
                        points3d=feats.points3d.cpu().numpy(),
                        valid3d=feats.valid3d.cpu().numpy(),
                        pose=pose.cpu().numpy(),
                        match_index=(matches.index.cpu().numpy()
                                     if matches is not None else None),
                        match_valid=(matches.valid.cpu().numpy()
                                     if matches is not None else None))
                    self._run_window_ba()

        with timer.stage("fusion"):
            self._frames_since_fuse += 1
            if fuse:
                self._frames_since_fuse = 0
                self._staged_points += self._frame_points  # upper bound
            periodic = (cfg.mapping.downsample_every > 0
                        and (self.frame_idx + 1) % cfg.mapping.downsample_every == 0)
            if self._staged_points and (
                    periodic
                    or self._staged_points + self._frame_points > self._staging_cap):
                flush_staging(self.gmap, self._staging, cfg.mapping.voxel_size,
                              cfg.mapping.bounds)
                self._host_cursor += self._staged_points  # survivor bound
                self._staged_points = 0
                if self._host_cursor + self._staging_cap >= self._capacity:
                    # rare: re-voxelize the whole main pool near capacity
                    self.gmap = downsample_map(self.gmap, cfg.mapping.voxel_size,
                                               cfg.mapping.bounds)
                    self._host_cursor = int(self.gmap.cursor)  # waits once

        record = {
            "frame": self.frame_idx,
            "keyframe": is_kf,
            "map_points": self._host_cursor,
            **{f"t_{k}_ms": v * 1e3 for k, v in timer.times.items()},
        }
        if used_vo is not None:
            record["used_vo"] = used_vo
            record["vo_inliers"] = inliers
        self.metrics.log(record)
        self.frame_idx += 1
        return record

    def _run_window_ba(self) -> None:
        """Refine the host window and write the refined poses back into the
        keyframes and the trajectory."""
        refined = self._ba.solve_window()
        if refined is None:
            return
        first = len(self.keyframes) - len(refined)
        for i, pose in enumerate(refined):
            kf = self.keyframes[first + i]
            pose_t = torch.as_tensor(pose, device=self.device)
            self.keyframes[first + i] = kf._replace(pose=pose_t)
            if kf.index < len(self.trajectory):
                self.trajectory[kf.index] = pose_t

    def _flush_ba_events(self, trajectory: np.ndarray) -> None:
        """Apply the deferred device-BA refinements to ``trajectory``: one
        bulk pull, then each keyframe entry gets the newest estimate that
        saw it."""
        if not self._ba_events:
            return
        refined_all = torch.stack([r for _, r in self._ba_events]).cpu().numpy()
        for (kf_indices, _), ref in zip(self._ba_events, refined_all):
            for slot, idx in enumerate(kf_indices):
                if idx < len(trajectory):
                    trajectory[idx] = ref[slot]
        self._ba_events = []

    def synchronize(self) -> None:
        """Wait for the device to finish the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finish(self) -> ReconstructionResult:
        """Flush the map and return trajectory + fused cloud + metrics. The
        stage means leave out the warmup frames, detected from stage-time
        outliers."""
        self.synchronize()
        elapsed = (time.perf_counter() - self._t_start) if self._t_start else 0.0
        cfg = self.cfg
        if self._staged_points:
            flush_staging(self.gmap, self._staging, cfg.mapping.voxel_size,
                          cfg.mapping.bounds)
            self._staged_points = 0
        self.gmap = downsample_map(self.gmap, cfg.mapping.voxel_size, cfg.mapping.bounds)
        pts, cols = map_to_numpy(self.gmap)
        for idx, u, c in self._pending_vo:
            self.metrics.records[idx]["used_vo"] = bool(u)
            self.metrics.records[idx]["vo_inliers"] = int(c)
        self._pending_vo = []
        warmup_frames = self.metrics.auto_warmup()
        summary = self.metrics.summary(skip_first=warmup_frames)
        summary["warmup_frames_excluded"] = warmup_frames
        summary["frames"] = self.frame_idx
        summary["keyframes"] = len(self.keyframes)
        if elapsed > 0:
            summary["frames_per_s"] = self.frame_idx / elapsed
        self.metrics.close()
        trajectory = (torch.stack(self.trajectory).cpu().numpy() if self.trajectory
                      else np.zeros((0, 4, 4), np.float32))
        self._flush_ba_events(trajectory)
        return ReconstructionResult(
            trajectory=trajectory,
            keyframe_indices=np.asarray([k.index for k in self.keyframes]),
            map_points=pts,
            map_colors=cols,
            metrics=summary,
        )


def reconstruct(dataset, config: PipelineConfig, rig: RectifiedRig,
                device: "torch.device | str") -> ReconstructionResult:
    """One-call API: iterate a dataset through the online loop on ``device``
    ("cuda" raises when there is no card)."""
    engine = OnlineReconstructor(config, rig, device)
    for frame in dataset:
        engine.process(frame)
    return engine.finish()
