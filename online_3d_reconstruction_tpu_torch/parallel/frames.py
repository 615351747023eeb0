"""Frame-batch parallelism (P1): independent per-frame stereo work split
over the mesh's ranks (port of parallel/frames.py). No collective but the
final gather: pure data parallelism."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from online_3d_reconstruction_tpu_torch.config import StereoConfig
from online_3d_reconstruction_tpu_torch.parallel.mesh import Mesh, all_gather, axis_index
from online_3d_reconstruction_tpu_torch.stereo.sgm import sgm_disparity


def _disparities(lefts: torch.Tensor, rights: torch.Tensor,
                 config: StereoConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    pairs = [sgm_disparity(left, right, config) for left, right in zip(lefts, rights)]
    return torch.stack([d for d, _ in pairs]), torch.stack([v for _, v in pairs])


def local_batch_disparity(lefts: torch.Tensor, rights: torch.Tensor,
                          config: StereoConfig, mesh: Mesh
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's B / n frames of the (B, H, W) batch through
    ``sgm_disparity``: (disparity (B/n, H, W), valid (B/n, H, W))."""
    b = lefts.shape[0]
    if b % mesh.size:
        raise ValueError(f"batch of {b} frames not divisible by {mesh.size} devices")
    per = b // mesh.size
    mine = slice(axis_index(mesh) * per, (axis_index(mesh) + 1) * per)
    return _disparities(lefts[mine].to(mesh.device), rights[mine].to(mesh.device), config)


def batch_disparity(lefts: torch.Tensor, rights: torch.Tensor, config: StereoConfig,
                    mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) stereo batch -> (disparity (B, H, W), valid (B, H, W)).

    With a mesh each rank runs B / n frames (on the card each frame
    launches K1 and K2) and the results are gathered onto every rank; B
    must divide by the mesh size. Without one the batch runs on the
    tensors' device.
    """
    if mesh is None:
        return _disparities(lefts, rights, config)
    disp, valid = local_batch_disparity(lefts, rights, config, mesh)
    return all_gather(disp, mesh), all_gather(valid, mesh)
