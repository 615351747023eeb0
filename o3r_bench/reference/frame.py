"""The reference's frame stages, from a raw float32 stereo frame to what
the online loop keeps: the 8-bit quantization a camera applies, the
rectification remap, SGM disparity (batched over frames), features and
their 3D lifts, the camera-frame cloud, tracking against a keyframe, and a
window BA event. Every stage is a plain copy (see the package docstring);
the configuration and the rig are the reference's own (``config``,
``calibration``), built from the benchmark's configuration file."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import se3
from .backproject import PointCloud, backproject_disparity
from .config import PipelineConfig
from .frontend import FrameFeatures, extract_frame_features, tracking_step
from .problem import StereoNoiseModel
from .rectify import rectify_pair, remap_bilinear
from .sgm import sgm_disparity_batch
from .tracks import _append, create_window, keyframe_core

_INV255 = float(np.float32(1.0 / 255.0))


def quantize(image: np.ndarray, device) -> torch.Tensor:
    """A float image in [0, 1] as the camera's 8-bit value, back in [0, 1]."""
    q = np.clip(image * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    return torch.from_numpy(q).to(device).to(torch.float32) * _INV255


class ReferenceFrames:
    """The reference pipeline's stages for one configuration and rig.
    ``storage`` overrides the SGM storage (the control's fp8)."""

    def __init__(self, cfg: PipelineConfig, rig, device, storage=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.storage = storage
        self.q = torch.as_tensor(np.asarray(rig.q), dtype=torch.float32, device=self.device)
        self.map_left = torch.as_tensor(np.asarray(rig.map_left, np.float32), device=self.device)
        self.map_right = torch.as_tensor(np.asarray(rig.map_right, np.float32),
                                         device=self.device)
        m = cfg.mapping
        self.cs = max(int(m.frame_point_stride), 1)
        self.cc = int(m.color_stride) or self.cs
        self.color_map = self.map_left[::self.cc, ::self.cc] / float(self.cc)
        self.noise_model = None
        if cfg.ba.obs_weighting and rig.fx > 0 and rig.baseline > 0:
            self.noise_model = StereoNoiseModel(
                fx=float(rig.fx), fy=float(rig.fy), baseline=float(rig.baseline),
                sigma_px=float(cfg.ba.sigma_pixel),
                sigma_disparity=float(cfg.ba.sigma_disparity))

    def rectified(self, left: np.ndarray, right: np.ndarray, color: np.ndarray,
                  first: bool = False):
        """The quantized, rectified (left, right, color at the color stride).
        The engine's ``first`` frame has no keyframe to track against and
        runs from the float images themselves (the color at full size)."""
        dev = self.device
        if first:
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
            left_r, right_r = rectify_pair(t(left), t(right), self.map_left, self.map_right)
            return left_r, right_r, remap_bilinear(t(color), self.map_left)
        left_r, right_r = rectify_pair(quantize(left, dev), quantize(right, dev),
                                       self.map_left, self.map_right)
        color_r = remap_bilinear(quantize(np.asarray(color)[::self.cc, ::self.cc], dev),
                                 self.color_map)
        return left_r, right_r, color_r

    def disparities(self, lefts: Sequence[torch.Tensor], rights: Sequence[torch.Tensor],
                    batch: int = 8) -> List[torch.Tensor]:
        out = []
        for s in range(0, len(lefts), batch):
            out.extend(sgm_disparity_batch(torch.stack(list(lefts[s:s + batch])),
                                           torch.stack(list(rights[s:s + batch])),
                                           self.cfg.stereo, self.storage))
        return out

    def features(self, left_r: torch.Tensor, disp: torch.Tensor) -> FrameFeatures:
        return extract_frame_features(left_r, disp, self.q, self.cfg.features,
                                      self.cfg.odometry)

    def world_cloud(self, disp: torch.Tensor, color_r: torch.Tensor,
                    pose: torch.Tensor) -> PointCloud:
        """The frame's cloud at the strides, moved into the world at ``pose``."""
        m = self.cfg.mapping
        cloud = backproject_disparity(
            disp, color_r, self.q, stride=self.cs, min_depth=m.min_depth,
            max_depth=m.max_depth, invalid_value=self.cfg.stereo.invalid_value,
            color_prestrided=True, color_substride=self.cc // self.cs)
        return PointCloud(se3.transform_points(pose, cloud.points), cloud.colors,
                          cloud.valid)

    def track(self, feats: FrameFeatures, kf_feats: FrameFeatures, kf_pose, kf_prior,
              prior, frame_idx: int):
        """(pose, matches) of a frame tracked against a keyframe."""
        pose, _, _, matches = tracking_step(feats, kf_feats, kf_pose, kf_prior, prior,
                                            int(frame_idx), self.cfg.matching,
                                            self.cfg.odometry)
        return pose, matches

    def window(self, slots, poses) -> object:
        """The device window holding ``slots`` (oldest first): each a
        (features, matches or None, prior) whose matches link it to the slot
        before, with the window poses ``poses`` (count, 4, 4)."""
        k = self.cfg.features.max_keypoints
        state = create_window(self.cfg.ba.window, k, self.device)
        no_idx = torch.zeros(k, dtype=torch.int64, device=self.device)
        no_ok = torch.zeros(k, dtype=torch.bool, device=self.device)
        for feats, matches, prior in slots:
            idx, ok = (no_idx, no_ok) if matches is None else (matches.index, matches.valid)
            state = _append(state, feats.points3d, feats.valid3d, idx, ok,
                            torch.eye(4, device=self.device), prior)
        count = len(slots)
        return state._replace(poses=torch.cat([poses[:count], state.poses[count:]]))

    def ba_event(self, state, feats: FrameFeatures, matches, pose, prior) -> torch.Tensor:
        """The refined window (W, 4, 4) after appending a keyframe."""
        _, refined, _ = keyframe_core(state, feats.points3d, feats.valid3d, matches.index,
                                      matches.valid, pose, prior, self.cfg.ba,
                                      noise_model=self.noise_model)
        return refined
