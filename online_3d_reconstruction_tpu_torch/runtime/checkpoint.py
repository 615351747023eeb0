"""Checkpoint / resume for the online loop (port of runtime/checkpoint.py).

A snapshot holds what the engine needs to continue at its next frame: the
main and staging map pools, the trajectory so far (with the deferred
window-BA refinements patched in), the keyframes with their features, the
device BA window (every field of ``ba.device_tracks.WindowState``, its host
live count included) or the host track table (``_next_lm``, each record's
``lm_of_kp``), and the host counters. Keys and stored dtypes are the
reference's wherever the state is the same: the descriptor words, octaves
and match indices that the port holds as int64 are stored at the
reference's 32 bits and widened again on load. There is no RNG key to save: each frame's RANSAC draw
comes from ``odometry.seed`` and the frame index
(``odometry.rigid.hypothesis_indices``), so a resumed run draws what an
uninterrupted one would. Snapshots are written atomically: a temp file in
the same directory, then ``os.replace``.
"""

from __future__ import annotations

import os
import tempfile
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import OnlineReconstructor

_FORMAT_VERSION = 3
_WINDOW_FIELDS = ("points3d", "valid3d", "match_idx", "match_ok", "poses", "priors")
_POOLS = (("map", "gmap"), ("stg", "_staging"))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(engine: "OnlineReconstructor", path: str) -> None:
    """Snapshot the engine's state to ``path`` (atomic)."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "frame_idx": np.int64(engine.frame_idx),
        "host_cursor": np.int64(engine._host_cursor),
        "staged_points": np.int64(engine._staged_points),
        "frames_since_fuse": np.int64(engine._frames_since_fuse),
        "trajectory": engine.trajectory_numpy().astype(np.float32),
        "n_keyframes": np.int64(len(engine.keyframes)),
    }
    for prefix, attr in _POOLS:
        pool = getattr(engine, attr)
        for name in ("points", "colors", "valid", "cursor"):
            payload[f"{prefix}_{name}"] = _np(getattr(pool, name))
    for i, kf in enumerate(engine.keyframes):
        kp = kf.features.keypoints
        payload[f"kf{i}_index"] = np.int64(kf.index)
        payload[f"kf{i}_pose"] = _np(kf.pose)
        payload[f"kf{i}_prior"] = _np(kf.prior_pose)
        payload[f"kf{i}_xy"] = _np(kp.xy)
        payload[f"kf{i}_score"] = _np(kp.score)
        payload[f"kf{i}_angle"] = _np(kp.angle)
        payload[f"kf{i}_desc"] = _np(kp.descriptors).astype(np.uint32)
        payload[f"kf{i}_kpvalid"] = _np(kp.valid)
        payload[f"kf{i}_octave"] = _np(kp.octave).astype(np.int32)
        payload[f"kf{i}_pts3d"] = _np(kf.features.points3d)
        payload[f"kf{i}_valid3d"] = _np(kf.features.valid3d)
    if engine._ba is not None:
        payload["ba_next_lm"] = np.int64(engine._ba._next_lm)
        payload["ba_n_kf"] = np.int64(len(engine._ba.keyframes))
        for i, rec in enumerate(engine._ba.keyframes):
            payload[f"ba{i}_index"] = np.int64(rec.index)
            payload[f"ba{i}_pts"] = rec.points3d
            payload[f"ba{i}_valid"] = rec.valid3d
            payload[f"ba{i}_pose"] = rec.pose
            payload[f"ba{i}_lm"] = rec.lm_of_kp
    if engine._ba_state is not None:
        state = engine._ba_state
        for name in _WINDOW_FIELDS:
            payload[f"bawin_{name}"] = _np(getattr(state, name))
        payload["bawin_match_idx"] = payload["bawin_match_idx"].astype(np.int32)
        payload["bawin_count"] = np.int64(state.count)

    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(engine: "OnlineReconstructor", path: str) -> None:
    """Restore ``engine`` (built with the snapshot's configuration) in place;
    it resumes at ``engine.frame_idx``."""
    from online_3d_reconstruction_tpu_torch.ba.device_tracks import WindowState
    from online_3d_reconstruction_tpu_torch.ba.window import _KfRecord
    from online_3d_reconstruction_tpu_torch.features.brief import Keypoints
    from online_3d_reconstruction_tpu_torch.mapping.global_map import GlobalMap
    from online_3d_reconstruction_tpu_torch.odometry.frontend import FrameFeatures
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import _Keyframe

    dev = engine.device
    with np.load(path, allow_pickle=False) as z:
        def t(key):
            value = z[key]
            if value.dtype in (np.uint32, np.int32):   # stored narrow, held as int64
                value = value.astype(np.int64)
            return torch.from_numpy(np.ascontiguousarray(value)).to(dev)

        version = int(z["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"checkpoint version {version} != {_FORMAT_VERSION}")
        engine.frame_idx = int(z["frame_idx"])
        engine._host_cursor = int(z["host_cursor"])
        engine._staged_points = int(z["staged_points"])
        engine._frames_since_fuse = int(z["frames_since_fuse"])
        engine.trajectory = list(t("trajectory").unbind(0))
        for prefix, attr in _POOLS:
            setattr(engine, attr, GlobalMap(*(t(f"{prefix}_{name}") for name in
                                              ("points", "colors", "valid", "cursor"))))
        engine.keyframes = []
        for i in range(int(z["n_keyframes"])):
            kp = Keypoints(xy=t(f"kf{i}_xy"), score=t(f"kf{i}_score"),
                           angle=t(f"kf{i}_angle"), descriptors=t(f"kf{i}_desc"),
                           valid=t(f"kf{i}_kpvalid"), octave=t(f"kf{i}_octave"))
            feats = FrameFeatures(keypoints=kp, points3d=t(f"kf{i}_pts3d"),
                                  valid3d=t(f"kf{i}_valid3d"))
            engine.keyframes.append(_Keyframe(index=int(z[f"kf{i}_index"]),
                                              features=feats, pose=t(f"kf{i}_pose"),
                                              prior_pose=t(f"kf{i}_prior")))
        if engine.keyframes:
            # the keyframe policy compares priors with the last keyframe's
            engine._last_kf_prior = z[f"kf{len(engine.keyframes) - 1}_prior"].astype(
                np.float64)
        engine._pending_vo = []
        engine._ba_events = []
        if engine._ba_state is not None and "bawin_poses" in z:
            engine._ba_state = WindowState(
                *(t(f"bawin_{name}") for name in _WINDOW_FIELDS),
                count=int(z["bawin_count"]))
        if engine._ba is not None and "ba_n_kf" in z:
            engine._ba._next_lm = int(z["ba_next_lm"])
            engine._ba.keyframes = []
            for i in range(int(z["ba_n_kf"])):
                rec = _KfRecord(index=int(z[f"ba{i}_index"]), points3d=z[f"ba{i}_pts"],
                                valid3d=z[f"ba{i}_valid"], pose=z[f"ba{i}_pose"])
                rec.lm_of_kp = z[f"ba{i}_lm"].copy()
                engine._ba.keyframes.append(rec)
