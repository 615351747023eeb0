"""PyTorch port, ``runtime/distributed.py``: the reference's
``test_distributed_loop_tracks`` with the port's ``reconstruct_distributed``
on FOUR CPU ranks (fresh processes over gloo) against the JAX single-device
loop computed here, every rank's result compared; then the loop on a mesh
of one rank, in process, against the port's ``reconstruct``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.config import config_to_dict
from online_3d_reconstruction_tpu.io.dataset import SyntheticSequence
from online_3d_reconstruction_tpu.io.synthetic import nadir_pose
from online_3d_reconstruction_tpu.runtime.pipeline import reconstruct as jreconstruct
from online_3d_reconstruction_tpu.utils.metrics import ate_rmse
from online_3d_reconstruction_tpu_torch.parallel.ba_sharded import solve_ba_sharded
from online_3d_reconstruction_tpu_torch.parallel.launch import run_ranks
from online_3d_reconstruction_tpu_torch.parallel.mesh import make_mesh
from online_3d_reconstruction_tpu_torch.runtime import distributed
from online_3d_reconstruction_tpu_torch.runtime.pipeline import reconstruct
from tests import test_torch_rank_jobs as jobs
from tests.test_odometry import _test_config, vo_rig, vo_scene  # noqa: F401
from tests.test_torch_shared import port

torch.set_num_threads(2)
WORLD = 4


@pytest.fixture(scope="module")
def flight(vo_scene, vo_rig):  # noqa: F811
    poses = [nadir_pose(0.8 * i, 0.1 * i, 12.0) for i in range(6)]
    dataset = SyntheticSequence(scene=vo_scene, rig=vo_rig, poses=poses)
    return [dataset[i] for i in range(6)], np.stack(poses)


def test_distributed_loop_tracks(flight, vo_rig, tmp_path):  # noqa: F811
    """Sharded SGM's halo truncation perturbs a handful of disparities: the
    four-rank loop tracks ground truth as the reference's single-device loop
    does (the reference test's bounds), with the same keyframes; and the
    ranks agree bit for bit (RANSAC draws are seeded by the frame index, the
    solves run on replicated values), with no broadcast."""
    frames, gt = flight
    cfg = _test_config()
    res_1 = jreconstruct(frames, cfg, vo_rig)

    inputs = dict(cfg=json.dumps(config_to_dict(cfg)), n_frames=len(frames))
    inputs.update(jobs.pack("rig", vo_rig))
    for i, frame in enumerate(frames):
        inputs.update(jobs.pack(f"frame{i}", frame))
    np.savez(tmp_path / "inputs.npz", **inputs)
    ranks = run_ranks("tests.test_torch_rank_jobs:distributed_loop", WORLD, tmp_path,
                      timeout=300.0)

    assert len(ranks) == WORLD
    ate_1 = ate_rmse(res_1.trajectory, gt)
    for r in ranks:
        ate_n = ate_rmse(r["trajectory"], gt)
        assert ate_n < max(2.0 * ate_1, 0.4), (ate_1, ate_n)
        assert len(r["map_points"]) > 500
        assert len(r["keyframes"]) == res_1.metrics["keyframes"]
        np.testing.assert_array_equal(r["keyframes"], res_1.keyframe_indices)
        np.testing.assert_array_equal(r["trajectory"], ranks[0]["trajectory"])
        np.testing.assert_array_equal(r["map_points"], ranks[0]["map_points"])


@pytest.mark.parametrize("host_ba", [False, True], ids=["device_window", "host_ba"])
def test_size1_loop_matches_reconstruct(flight, vo_rig, host_ba):  # noqa: F811
    """One rank, no process group: same keyframes as ``reconstruct``, poses
    within 0.05 m (the zero halos of the size-1 slab move a few
    disparities), the map within 2%; with ``host_ba`` the track table
    solves through the sharded solver."""
    frames, gt = flight
    cfg = port(_test_config())
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, host_ba=host_ba))
    frames, rig = port(frames), port(vo_rig)
    mesh = make_mesh(device="cpu")
    engine = distributed.DistributedReconstructor(cfg, rig, mesh, sgm_halo=16, device="cpu")
    assert engine.mesh is mesh and (engine._ba is not None) == host_ba
    if host_ba:
        assert engine._ba.solver.func is solve_ba_sharded
    want = reconstruct(frames, cfg, rig, device="cpu")
    got = distributed.reconstruct_distributed(frames, cfg, rig, mesh, sgm_halo=16,
                                              device="cpu")
    np.testing.assert_array_equal(got.keyframe_indices, want.keyframe_indices)
    dt = np.linalg.norm(got.trajectory[:, :3, 3] - want.trajectory[:, :3, 3], axis=1)
    assert dt.max() < 0.05, dt
    assert abs(len(got.map_points) - len(want.map_points)) <= 0.02 * len(want.map_points)
    assert ate_rmse(got.trajectory, gt) < 0.4


def test_initialize_and_engine_arguments(vo_rig):  # noqa: F811
    assert distributed.initialize() is None          # no address: nothing to do
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="mesh computes on cpu"):
        distributed.DistributedReconstructor(port(_test_config()), port(vo_rig), mesh,
                                             device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(device="cuda")                     # no card here, no fallback
