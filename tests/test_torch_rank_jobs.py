"""The per-rank bodies of the port's multi-rank tests (no test is collected
from this file). ``parallel.launch.run_ranks`` imports it in each of its
fresh CPU rank processes, so it imports torch and the port only, never JAX:
the parent test computes the JAX side. Each job reads the inputs the parent
wrote to ``workdir/inputs.npz`` and returns arrays; ``parallel_jobs`` runs
them all in one launch (one start-up for the whole file) and records a
failed job as ``<job>/error``, so that one fault fails one test.
"""

import json
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.ba.device_tracks import create_window, keyframe_core
from online_3d_reconstruction_tpu_torch.ba.problem import BAProblem, problem_from_numpy
from online_3d_reconstruction_tpu_torch.config import config_from_dict, section_from_dict
from online_3d_reconstruction_tpu_torch.io.calibration import rig_from_numpy
from online_3d_reconstruction_tpu_torch.io.dataset import frame_from_numpy
from online_3d_reconstruction_tpu_torch.parallel.ba_sharded import (
    solve_ba_sharded,
    solve_ba_slot_sharded,
)
from online_3d_reconstruction_tpu_torch.parallel.frames import batch_disparity
from online_3d_reconstruction_tpu_torch.parallel.sgm_sharded import sharded_disparity
from online_3d_reconstruction_tpu_torch.parallel.voxel_sharded import (
    sharded_voxel_downsample,
    voxel_route_merge,
)
from online_3d_reconstruction_tpu_torch.runtime.distributed import reconstruct_distributed


def pack(prefix: str, obj) -> dict:
    """The array fields of a NamedTuple / dataclass / dict as npz entries
    ``<prefix>.<field>`` (None fields left out)."""
    fields = obj if isinstance(obj, dict) else (
        obj._asdict() if hasattr(obj, "_asdict") else vars(obj))
    return {f"{prefix}.{k}": np.asarray(v) for k, v in fields.items() if v is not None}


def unpack(z, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: z[k] for k in z.files if k.startswith(prefix + ".")}


def _problem(z, prefix: str) -> BAProblem:
    return problem_from_numpy(SimpleNamespace(**unpack(z, prefix)), "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _solution(result) -> dict:
    poses, landmarks, trace = result
    return dict(poses=poses.numpy(), landmarks=landmarks.numpy(), trace=trace.numpy())


def _ba(z, mesh, name):
    kw = json.loads(str(z[f"{name}.kw"]))
    return _solution(solve_ba_sharded(_problem(z, name), mesh, **kw))


def _slot_ba(z, mesh):
    kw = json.loads(str(z["slot.kw"]))
    return _solution(solve_ba_slot_sharded(_problem(z, "slot"), mesh, **kw))


def _slot_ba_rejects(z, mesh):
    try:
        solve_ba_slot_sharded(_problem(z, "slot_bad"), mesh, slot_major=16, iters=1)
    except ValueError as err:
        return dict(message=np.array(str(err)))
    return dict(message=np.array(""))


def window_events(seed0: int = 100, k: int = 64, n: int = 5):
    """The five synthetic keyframe events of the reference's
    TestShardedWindowBA, as numpy arrays."""
    for i in range(n):
        rng = np.random.default_rng(seed0 + i)
        points = rng.normal(0, 3, (k, 3)).astype(np.float32)
        valid = rng.random(k) < 0.9
        match_idx = rng.integers(0, k, k).astype(np.int32)
        match_ok = rng.random(k) < 0.7
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [i, 0.1 * i, 0.0]
        yield points, valid, match_idx, match_ok, pose


def window_refined(cfg, mesh) -> np.ndarray:
    """The refined window after the five events, through ``keyframe_core``
    with ``mesh`` (None: the single-device solve)."""
    state = create_window(cfg.window, 64, "cpu")
    for points, valid, match_idx, match_ok, pose in window_events():
        state, refined, _ = keyframe_core(
            state, _t(points), _t(valid), _t(match_idx.astype(np.int64)), _t(match_ok),
            _t(pose), _t(pose), cfg, mesh=mesh)
    return refined.numpy()


def _window_ba(z, mesh):
    cfg = section_from_dict("ba", json.loads(str(z["window.cfg"])))
    return dict(refined=window_refined(cfg, mesh))


def _batch(z, mesh):
    cfg = section_from_dict("stereo", json.loads(str(z["batch.cfg"])))
    disp, valid = batch_disparity(_t(z["batch.lefts"]), _t(z["batch.rights"]), cfg, mesh)
    return dict(disp=disp.numpy(), valid=valid.numpy())


def _cloud(cloud) -> dict:
    return dict(points=cloud.points.numpy(), colors=cloud.colors.numpy(),
                valid=cloud.valid.numpy())


def _voxel(z, mesh):
    pts, cols, val = (_t(z[f"voxel.{k}"]) for k in ("points", "colors", "valid"))
    return _cloud(sharded_voxel_downsample(pts, cols, val, mesh, voxel_size=1.0,
                                           bounds=64.0))


def _route(z, mesh):
    pts, cols, val = (_t(z[f"route.{k}"]) for k in ("points", "colors", "valid"))
    cloud, dropped = voxel_route_merge(pts, cols, val, mesh, voxel_size=1.0, bounds=64.0)
    return dict(_cloud(cloud), dropped=dropped.numpy())


def _route_overflow(z, mesh):
    pts = _t(z["overflow.points"])
    n = pts.shape[0]
    cloud, dropped = voxel_route_merge(
        pts, torch.zeros((n, 3)), torch.ones(n, dtype=torch.bool), mesh,
        voxel_size=0.25, bounds=64.0, bucket_capacity=4)
    return dict(dropped=dropped.numpy(), kept=cloud.valid.sum().numpy())


def _sgm(z, mesh):
    cfg = section_from_dict("stereo", json.loads(str(z["sgm.cfg"])))
    disp, valid = sharded_disparity(_t(z["sgm.left"]), _t(z["sgm.right"]), cfg, mesh,
                                    halo=16)
    out = dict(disp=disp.numpy(), valid=valid.numpy())
    for name, (h, halo) in dict(rows=(190, 32), halo=(192, 48)).items():
        try:
            sharded_disparity(torch.zeros((h, 256)), torch.zeros((h, 256)), cfg, mesh,
                              halo=halo)
            out[f"rejects_{name}"] = np.array("")
        except ValueError as err:
            out[f"rejects_{name}"] = np.array(str(err))
    return out


_JOBS = {
    "ba": lambda z, mesh: _ba(z, mesh, "ba"),
    "ba_uneven": lambda z, mesh: _ba(z, mesh, "ba_uneven"),
    "window": _window_ba,
    "slot": _slot_ba,
    "slot_bad": _slot_ba_rejects,
    "batch": _batch,
    "voxel": _voxel,
    "route": _route,
    "overflow": _route_overflow,
    "sgm": _sgm,
}


def parallel_jobs(mesh, workdir):
    out = {}
    with np.load(Path(workdir) / "inputs.npz") as z:
        for name, job in _JOBS.items():
            try:
                out.update({f"{name}/{k}": v for k, v in job(z, mesh).items()})
            except Exception:   # one job's fault is reported by that job's test
                out[f"{name}/error"] = np.array(traceback.format_exc())
    return out


def distributed_loop(mesh, workdir):
    """``reconstruct_distributed`` over the frames of ``inputs.npz``."""
    with np.load(Path(workdir) / "inputs.npz") as z:
        cfg = config_from_dict(json.loads(str(z["cfg"])))
        rig = rig_from_numpy(unpack(z, "rig"))
        n = int(z["n_frames"])
        frames = [frame_from_numpy(unpack(z, f"frame{i}")) for i in range(n)]
    res = reconstruct_distributed(frames, cfg, rig, mesh, sgm_halo=16, device="cpu")
    return dict(trajectory=res.trajectory, keyframes=res.keyframe_indices,
                map_points=res.map_points)
