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
the engine's device.

The runtime options:

- ``runtime.use_precomputed_disparity`` (offline mode): a frame that carries
  a disparity map skips SGM; the map travels in the packed frame as 1/16-px
  fixed point.
- ``runtime.checkpoint_every`` snapshots the engine on every N-th keyframe to
  ``<checkpoint_dir>/snapshot.npz`` (runtime/checkpoint.py).
- ``runtime.debug_nans`` checks every stage's floating outputs for NaN and
  raises ``FloatingPointError`` naming the stage and the frame. It waits for
  the device once per stage; off, it costs nothing.
- ``run_frames`` (and so ``reconstruct``) packs and uploads frames
  ``runtime.prefetch_depth`` ahead in a worker thread (runtime/prefetch.py),
  and with ``runtime.profile`` records a ``torch.profiler`` trace under
  ``<checkpoint_dir>/profile/``.

With the prefetcher the steady frame's upload never waits for the device;
the host then waits inside a steady frame only where ``runtime.sync_metrics``
asks for the VO scalars every frame, where ``runtime.host_ba`` pulls a
keyframe's tracks, or where the ported stages themselves synchronize.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, NamedTuple, Optional

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
from online_3d_reconstruction_tpu_torch.runtime.checkpoint import save_checkpoint
from online_3d_reconstruction_tpu_torch.runtime.prefetch import device_prefetch
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


def _color_stride(map_cfg) -> int:
    """Color-plane stride (0 = the point stride); a multiple of the point
    stride so each color texel serves a whole block of points."""
    cs = max(int(map_cfg.frame_point_stride), 1)
    cc = int(map_cfg.color_stride) or cs
    if cc % cs:
        raise ValueError(f"mapping.color_stride ({cc}) must be a multiple of "
                         f"frame_point_stride ({cs})")
    return cc


def pack_frame(frame: FrameData, use_disparity: bool = False,
               color_stride: int = 1, frame_index: int = 0) -> np.ndarray:
    """One frame as one flat uint8 buffer: an 80-byte float32 header (prior
    pose, frame index) | left gray | right gray | color subsampled by
    ``color_stride`` [| disparity lo | hi byte planes]. Gray and color are
    quantized to 8 bits, as a camera delivers them; the optional disparity
    is 1/16-px uint16 fixed point with 0xFFFF marking invalid pixels (the
    reference's layout)."""
    def q8(x):
        return np.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)

    header = np.zeros(_HEADER_FLOATS, dtype=np.float32)
    header[:16] = np.asarray(frame.prior_pose, dtype=np.float32).ravel()
    header[16] = float(frame_index)
    cs = max(int(color_stride), 1)
    parts = [header.view(np.uint8), q8(frame.left).ravel(), q8(frame.right).ravel(),
             q8(np.asarray(frame.color)[::cs, ::cs]).ravel()]
    if use_disparity:
        d = np.asarray(frame.disparity, dtype=np.float32)
        fixed = np.where(d >= 0.0, np.clip(np.round(d * 16.0), 0, 65534),
                         65535).astype(np.uint16)
        parts.append((fixed & 0xFF).astype(np.uint8).ravel())
        parts.append((fixed >> 8).astype(np.uint8).ravel())
    return np.concatenate(parts)


def unpack_frame(packed: torch.Tensor, h: int, w: int, color_stride: int,
                 invalid_value: float = -1.0, precomputed_disp: bool = False):
    """Inverse of ``pack_frame`` on the device: (prior (4, 4), left (H, W),
    right (H, W), color (ceil(H/cs), ceil(W/cs), 3), disparity (H, W) or
    None), images in [0, 1], invalid disparities set to ``invalid_value``."""
    prior = packed[:_HEADER_BYTES].view(torch.float32)[:16].reshape(4, 4)
    hw = h * w
    off = _HEADER_BYTES
    left = packed[off:off + hw].reshape(h, w).to(torch.float32) * _INV255
    off += hw
    right = packed[off:off + hw].reshape(h, w).to(torch.float32) * _INV255
    off += hw
    hs, ws = -(-h // color_stride), -(-w // color_stride)
    color = packed[off:off + hs * ws * 3].reshape(hs, ws, 3).to(torch.float32) * _INV255
    off += hs * ws * 3
    disp = None
    if precomputed_disp:
        lo = packed[off:off + hw].reshape(h, w).to(torch.float32)
        hi = packed[off + hw:off + 2 * hw].reshape(h, w).to(torch.float32)
        raw = lo + 256.0 * hi
        disp = torch.where(raw >= 65535.0, invalid_value, raw * (1.0 / 16.0))
    return prior, left, right, color, disp


def _float_tensors(value):
    """The floating-point tensors in a (nested) tuple of results."""
    if isinstance(value, torch.Tensor):
        if value.is_floating_point():
            yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _float_tensors(v)


class OnlineReconstructor:
    """Streaming engine: feed ``FrameData``, read back trajectory + map."""

    # the mesh of the window solve; runtime/distributed.py sets one
    mesh = None

    def __init__(self, config: PipelineConfig, rig: RectifiedRig,
                 device: "torch.device | str"):
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
        self._pending_vo: List = []   # deferred (record, used_vo, count)
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

    def _use_disparity(self, frame: FrameData) -> bool:
        """Offline mode: opted into by the config AND carried by the frame."""
        return (self.cfg.runtime.use_precomputed_disparity
                and frame.disparity is not None)

    def _check(self, stage: str, *values) -> None:
        """``runtime.debug_nans``: raise if a stage produced a NaN (one wait
        for the device per stage)."""
        if not self.cfg.runtime.debug_nans:
            return
        flags = [torch.isnan(t).any() for t in _float_tensors(values)]
        if flags and bool(torch.stack(flags).any()):
            raise FloatingPointError(
                f"NaN in the {stage} stage at frame {self.frame_idx}")

    def pack(self, frame: FrameData, frame_index: Optional[int] = None) -> np.ndarray:
        """This engine's packed buffer for ``frame`` (the prefetcher calls it
        ahead of ``process``)."""
        return pack_frame(frame, self._use_disparity(frame), color_stride=self._cc,
                          frame_index=self.frame_idx if frame_index is None else frame_index)

    def _cloud(self, disp, color_r, prestrided: bool) -> PointCloud:
        m = self.cfg.mapping
        return backproject_disparity(
            disp, color_r, self.q, stride=self._cs, min_depth=m.min_depth,
            max_depth=m.max_depth, invalid_value=self.cfg.stereo.invalid_value,
            color_prestrided=prestrided,
            color_substride=self._cc // self._cs if prestrided else 1)

    def _rectify(self, left, right, color, color_map):
        if self._skip_rectify:
            return left, right, color
        left_r, right_r = rectify_pair(left, right, self.map_left, self.map_right)
        return left_r, right_r, remap_bilinear(color, color_map)

    def _compute_disparity(self, left_r: torch.Tensor, right_r: torch.Tensor) -> torch.Tensor:
        """The disparity stage of a frame, on the rectified pair (the hook
        the distributed engine overrides with its row-slab form)."""
        return sgm_disparity(left_r, right_r, self.cfg.stereo)[0]

    def _keyframe_event(self, feats: FrameFeatures, match_idx, match_ok, pose, prior):
        """Append the frame to the device window and refine it; returns the
        refined window poses (W, 4, 4)."""
        self._ba_state, refined, _ = keyframe_core(
            self._ba_state, feats.points3d, feats.valid3d, match_idx, match_ok,
            pose, prior, self.cfg.ba, mesh=self.mesh, noise_model=self._noise_model)
        self._check("ba", refined)
        return refined

    def _frame_stage(self, frame: FrameData, use_disp: bool):
        """First frame, from the float images: rectify -> disparity ->
        features -> camera-frame cloud (full-resolution color)."""
        dev = self.device

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        left_r, right_r, color_r = self._rectify(t(frame.left), t(frame.right),
                                                 t(frame.color), self.map_left)
        self._check("rectify", left_r, right_r, color_r)
        if use_disp:
            disp = t(frame.disparity)
        else:
            disp = self._compute_disparity(left_r, right_r)
        self._check("disparity", disp)
        feats = extract_frame_features(left_r, disp, self.q, self.cfg.features,
                                       self.cfg.odometry)
        self._check("features", feats)
        cloud = self._cloud(disp, color_r, prestrided=False)
        self._check("cloud", cloud)
        return feats, cloud

    def _insert(self, pose, cloud: PointCloud) -> None:
        world = PointCloud(se3.transform_points(pose, cloud.points), cloud.colors,
                           cloud.valid)
        self._check("insert", world)
        insert_cloud(self._staging, world)

    def _steady_step(self, packed, kf: _Keyframe, fuse: bool, ba_event: bool,
                     use_disp: bool):
        """A steady frame: unpack -> rectify -> disparity -> features ->
        cloud -> tracking [-> window BA] -> insert into the staging pool.
        With ``ba_event`` the frame is a keyframe: the device window appends
        it and refines, and the frame's pose is its refined one (the
        reference's ``_steady_step_kf``). Returns (pose, prior, feats,
        used_vo, inlier_count, matches, refined window poses or None)."""
        cfg = self.cfg
        packed = torch.as_tensor(packed).to(self.device)
        prior, left, right, color, disp = unpack_frame(
            packed, cfg.stereo.height, cfg.stereo.width, self._cc,
            cfg.stereo.invalid_value, use_disp)
        self._check("unpack", prior, left, right, color, disp)
        left_r, right_r, color_r = self._rectify(left, right, color, self._color_map)
        self._check("rectify", left_r, right_r, color_r)
        if not use_disp:
            disp = self._compute_disparity(left_r, right_r)
        self._check("disparity", disp)
        feats = extract_frame_features(left_r, disp, self.q, cfg.features, cfg.odometry)
        self._check("features", feats)
        cloud = self._cloud(disp, color_r, prestrided=True)
        self._check("cloud", cloud)
        pose, used_vo, count, matches = tracking_step(
            feats, kf.features, kf.pose, kf.prior_pose, prior, self.frame_idx,
            cfg.matching, cfg.odometry)
        self._check("tracking", pose)
        refined = None
        if ba_event:
            refined = self._keyframe_event(feats, matches.index, matches.valid,
                                           pose, prior)
            pose = refined[self._ba_state.count - 1]
        if fuse:
            self._insert(pose, cloud)
        return pose, prior, feats, used_vo, count, matches, refined

    def process(self, frame: FrameData, packed=None) -> dict:
        """Run one frame through the pipeline; returns its metrics record.
        ``packed`` is the frame's ``pack`` buffer when a prefetcher made it
        ahead (a numpy array, or a tensor already on the engine's device)."""
        if self._t_start is None:
            self._t_start = time.perf_counter()
        timer = StageTimer()
        cfg = self.cfg
        used_vo: object = False
        inliers: object = 0
        matches = None
        refined = None
        deferred_vo = None
        fuse = self._frames_since_fuse + 1 >= cfg.mapping.fuse_every
        use_disp = self._use_disparity(frame)
        # the keyframe policy reads only host-side priors, so the host knows
        # before the step whether this frame's window BA runs inside it
        is_kf = self._is_keyframe(frame.prior_pose)
        if not self.keyframes:
            # first frame: anchor the world to the prior (no tracking target)
            prior = torch.as_tensor(frame.prior_pose, dtype=torch.float32,
                                    device=self.device)
            with timer.stage("frame_compute"):
                feats, cloud = self._frame_stage(frame, use_disp)
            pose = prior
            if fuse:
                with timer.stage("fusion"):
                    self._insert(pose, cloud)
        else:
            with timer.stage("step"):
                if packed is None:
                    packed = self.pack(frame)
                (pose, prior, feats, used_vo_t, count, matches,
                 refined) = self._steady_step(packed, self.keyframes[-1], fuse,
                                              is_kf and self._ba_state is not None,
                                              use_disp)
                if cfg.runtime.sync_metrics:
                    used_vo = bool(used_vo_t)   # waits for the device
                    inliers = int(count)
                else:
                    deferred_vo = (used_vo_t, count)
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
                        refined = self._keyframe_event(feats, m_idx, m_ok, pose, prior)
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

        index = self.frame_idx
        # the frame is done: a snapshot taken now resumes at the next one
        self.frame_idx += 1
        if (cfg.runtime.checkpoint_every > 0 and is_kf
                and len(self.keyframes) % cfg.runtime.checkpoint_every == 0):
            with timer.stage("checkpoint"):
                save_checkpoint(self, os.path.join(cfg.runtime.checkpoint_dir,
                                                   "snapshot.npz"))

        record = {
            "frame": index,
            "keyframe": is_kf,
            "map_points": self._host_cursor,
            **{f"t_{k}_ms": v * 1e3 for k, v in timer.times.items()},
        }
        if used_vo is not None:
            record["used_vo"] = used_vo
            record["vo_inliers"] = inliers
        if deferred_vo is not None:
            self._pending_vo.append((record, *deferred_vo))
        self.metrics.log(record)
        return record

    def _run_window_ba(self) -> None:
        """Refine the host window and write the refined poses back into the
        keyframes and the trajectory."""
        refined = self._ba.solve_window()
        if refined is None:
            return
        if self.cfg.runtime.debug_nans and np.isnan(np.stack(refined)).any():
            raise FloatingPointError(f"NaN in the ba stage at frame {self.frame_idx}")
        first = len(self.keyframes) - len(refined)
        for i, pose in enumerate(refined):
            kf = self.keyframes[first + i]
            pose_t = torch.as_tensor(pose, device=self.device)
            self.keyframes[first + i] = kf._replace(pose=pose_t)
            if kf.index < len(self.trajectory):
                self.trajectory[kf.index] = pose_t

    def _apply_ba_events(self, trajectory: np.ndarray) -> None:
        """Patch the deferred device-BA refinements into the numpy
        ``trajectory`` (one bulk pull): each keyframe entry gets the newest
        estimate that saw it. Entries are indexed by frame, counted from the
        start of the run."""
        if not self._ba_events:
            return
        refined_all = torch.stack([r for _, r in self._ba_events]).cpu().numpy()
        for (kf_indices, _), ref in zip(self._ba_events, refined_all):
            for slot, idx in enumerate(kf_indices):
                if idx < len(trajectory):
                    trajectory[idx] = ref[slot]

    def trajectory_numpy(self) -> np.ndarray:
        """The (N, 4, 4) trajectory so far on the host, with the window-BA
        refinements patched in as ``finish`` does."""
        if not self.trajectory:
            return np.zeros((0, 4, 4), np.float32)
        trajectory = torch.stack(self.trajectory).cpu().numpy()
        self._apply_ba_events(trajectory)
        return trajectory

    def snapshot_map(self):
        """The current map (main pool + staged frames) and trajectory, for a
        live view, in one pull from the device; the loop itself is left as it
        was. Returns (points (N, 3), colors (N, 3), trajectory (K, 4, 4)),
        the trajectory without the deferred window-BA patches (the
        reference's semantics)."""
        pools = (self.gmap, self._staging)
        flat = torch.cat(
            [torch.cat([p.points, p.colors, p.valid[:, None].to(torch.float32)], 1).reshape(-1)
             for p in pools]
            + [torch.stack(self.trajectory).reshape(-1) if self.trajectory
               else torch.zeros(0, device=self.device)]).cpu().numpy()
        n_pool = sum(p.points.shape[0] for p in pools)
        table = flat[:n_pool * 7].reshape(n_pool, 7)
        keep = table[:, 6] > 0
        traj = flat[n_pool * 7:].reshape(-1, 4, 4)
        return table[keep, :3], table[keep, 3:6], traj

    def synchronize(self) -> None:
        """Wait for the device to finish the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finish(self, warmup_frames: Optional[int] = None) -> ReconstructionResult:
        """Flush the map and return trajectory + fused cloud + metrics.
        ``warmup_frames`` frames are left out of the stage means; None
        detects them from stage-time outliers."""
        self.synchronize()
        elapsed = (time.perf_counter() - self._t_start) if self._t_start else 0.0
        cfg = self.cfg
        if self._staged_points:
            flush_staging(self.gmap, self._staging, cfg.mapping.voxel_size,
                          cfg.mapping.bounds)
            self._staged_points = 0
        self.gmap = downsample_map(self.gmap, cfg.mapping.voxel_size, cfg.mapping.bounds)
        pts, cols = map_to_numpy(self.gmap)
        if self._pending_vo:
            # deferred VO scalars: one bulk pull, patched into their records
            vals = torch.stack([torch.stack([u.to(torch.int64), c.to(torch.int64)])
                                for _, u, c in self._pending_vo]).cpu().tolist()
            for (record, _, _), (u, c) in zip(self._pending_vo, vals):
                record["used_vo"] = bool(u)
                record["vo_inliers"] = int(c)
            self._pending_vo = []
        if warmup_frames is None:
            warmup_frames = self.metrics.auto_warmup()
        summary = self.metrics.summary(skip_first=warmup_frames)
        summary["warmup_frames_excluded"] = warmup_frames
        summary["frames"] = self.frame_idx
        summary["keyframes"] = len(self.keyframes)
        if elapsed > 0:
            summary["frames_per_s"] = len(self.metrics.records) / elapsed
        self.metrics.close()
        trajectory = self.trajectory_numpy()
        self._ba_events = []
        return ReconstructionResult(
            trajectory=trajectory,
            keyframe_indices=np.asarray([k.index for k in self.keyframes]),
            map_points=pts,
            map_colors=cols,
            metrics=summary,
        )


def run_frames(engine: OnlineReconstructor, frames,
               on_record: Optional[Callable[[dict], None]] = None) -> None:
    """Feed ``frames`` through ``engine`` in order, packed and uploaded
    ``runtime.prefetch_depth`` frames ahead by a worker thread, inside a
    ``torch.profiler`` trace (``<checkpoint_dir>/profile/trace.json``) when
    ``runtime.profile`` is set. ``on_record`` sees each frame's record."""
    rt = engine.cfg.runtime
    profiler = trace_dir = None
    if rt.profile:
        trace_dir = os.path.join(rt.checkpoint_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    stream = device_prefetch(frames, engine, rt.prefetch_depth)
    try:
        for frame, packed in stream:
            record = engine.process(frame, packed=packed)
            if on_record is not None:
                on_record(record)
    finally:
        stream.close()
        if profiler is not None:
            profiler.stop()
            profiler.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def reconstruct(dataset, config: PipelineConfig, rig: RectifiedRig,
                device: "torch.device | str") -> ReconstructionResult:
    """One-call API: run a dataset through the online loop on ``device``
    ("cuda" raises when there is no card)."""
    engine = OnlineReconstructor(config, rig, device)
    run_frames(engine, dataset)
    return engine.finish()
