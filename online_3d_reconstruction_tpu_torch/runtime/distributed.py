"""Multi-rank reconstruction (port of runtime/distributed.py).

- ``initialize(...)`` joins this process to the ``torch.distributed``
  process group (once per process, before ``parallel.make_mesh``; a no-op
  without a coordinator address).
- ``reconstruct_distributed(dataset, config, rig, mesh)`` runs the online
  loop with the sharded stages swapped in: row-slab SGM with halo exchange
  (parallel/sgm_sharded.py) and the observation-sharded Schur solve
  (parallel/ba_sharded.py). SPMD: every process iterates the same dataset
  and makes every collective call; the results are equal on every process.
  RANSAC draws are the reference's, made from ``odometry.seed`` and the
  frame index, so the ranks agree on them without a broadcast. Its steady
  step runs eagerly: capturing its collectives in a CUDA graph is not done
  yet.

The map pool stays process-local (parallel/voxel_sharded.py is the
operation for a global reduction of sharded pools).

Several ranks on one machine, one card each::

    torchrun --nproc-per-node 4 script.py

with, in ``script.py``, ``initialize("env://")`` and then
``reconstruct_distributed(frames, config, rig, make_mesh())``; or start the
processes yourself and give each the same address, the world size and its
rank: ``initialize("tcp://host:port", 4, rank)``.
"""

from __future__ import annotations

import datetime
import functools
from typing import Optional

import torch
import torch.distributed as dist

from online_3d_reconstruction_tpu_torch.ba.window import WindowBA
from online_3d_reconstruction_tpu_torch.config import PipelineConfig
from online_3d_reconstruction_tpu_torch.io import RectifiedRig
from online_3d_reconstruction_tpu_torch.parallel.ba_sharded import solve_ba_sharded
from online_3d_reconstruction_tpu_torch.parallel.mesh import Mesh
from online_3d_reconstruction_tpu_torch.parallel.sgm_sharded import sharded_disparity
from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
    OnlineReconstructor,
    ReconstructionResult,
    run_frames,
)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the process group (before ``make_mesh``). Without an address
    there is one process and nothing to do. The address is an init method
    of ``torch.distributed`` (``tcp://host:port``, ``file:///path``,
    ``env://``; a bare ``host:port`` means tcp). ``backend`` defaults to
    ``nccl`` where there is a card and ``gloo`` where there is none; with
    ``nccl`` the process takes the card of its rank on this machine.
    ``timeout_s`` bounds the rendezvous and every later collective (the
    backend's default otherwise). A failed initialisation raises."""
    if coordinator_address is None:
        return  # single process: nothing to do
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    # -1: left to the init method (``env://`` reads both from the environment)
    dist.init_process_group(
        backend, init_method=coordinator_address,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=None if timeout_s is None else datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


class DistributedReconstructor(OnlineReconstructor):
    """Online loop whose stereo and BA stages run sharded over a mesh.

    The BA backend is the same device-resident window as the single-rank
    loop: the track build and the problem packing run replicated
    (ba/device_tracks.py), only the Schur solve inside swaps for the
    observation-sharded reduction. ``runtime.host_ba=True`` still selects
    the host track table (it then uses the sharded solver too). The engine
    computes on the mesh's device.
    """

    def __init__(self, config: PipelineConfig, rig: RectifiedRig, mesh: Mesh,
                 sgm_halo: int = 32, device: "torch.device | str" = "cuda"):
        if torch.device(device).type != mesh.device.type:
            raise ValueError(f"the mesh computes on {mesh.device}, the engine was "
                             f"asked for {device!r}")
        super().__init__(config, rig, mesh.device, _step="eager")
        self.mesh = mesh
        self.sgm_halo = sgm_halo
        if self._ba is not None:
            self._ba = WindowBA(
                config.ba, solver=functools.partial(solve_ba_sharded, mesh=mesh),
                noise_model=self._noise_model, device=self.device)

    def _compute_disparity(self, left_r: torch.Tensor, right_r: torch.Tensor) -> torch.Tensor:
        return sharded_disparity(left_r, right_r, self.cfg.stereo, self.mesh,
                                 halo=self.sgm_halo)[0]


def reconstruct_distributed(dataset, config: PipelineConfig, rig: RectifiedRig,
                            mesh: Mesh, sgm_halo: int = 32,
                            device: "torch.device | str" = "cuda"
                            ) -> ReconstructionResult:
    """Multi-rank ``reconstruct``: same API plus a mesh, sharded stereo and
    BA stages. Every process of the mesh must call it on the same dataset."""
    engine = DistributedReconstructor(config, rig, mesh, sgm_halo=sgm_halo, device=device)
    run_frames(engine, dataset)
    return engine.finish()
