"""The device mesh of the multi-rank paths, on ``torch.distributed`` (port
of parallel/mesh.py).

The reference is one controller over global arrays sharded on a
``jax.sharding.Mesh``; ``torch.distributed`` is one process per rank. The
port's ``Mesh`` is this process's view of one linear axis (default ``"d"``):
how many ranks it has, which one this process is, the process group they
talk over and the device this rank computes on. The convention of every
public function of ``parallel/``: it takes the reference's logical (global)
arguments on every rank, takes its own shard by rank where the reference
shards, and returns the reference's logical result on every rank. The
per-rank bodies are module-level functions that return local shards, for a
caller that wants to stay sharded.

The collectives the four modules need are thin functions on a mesh here
(``psum``, ``all_gather``, ``all_to_all``, ``shift``, ``axis_index``); on a
mesh without a group, which is what ``make_mesh`` gives for one rank, each
is the identity (``shift``: zeros). Multi-host: call
``runtime.distributed.initialize`` in every process before ``make_mesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_AXIS = "d"


@dataclass(frozen=True)
class Mesh:
    """One linear mesh axis as this process sees it."""

    axis_names: Tuple[str, ...]
    size: int                      # ranks along the axis
    rank: int                      # this process's index (-1: not a member)
    group: Optional[dist.ProcessGroup]   # None: one rank, collectives are the identity
    device: torch.device           # where this rank computes


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DEFAULT_AXIS,
              device: "torch.device | str" = "cuda") -> Mesh:
    """Linear mesh over the first ``n_devices`` ranks of the initialised
    process group (all by default), computing on ``device`` ("cuda" raises
    when there is no card). With no process group the mesh has one rank.
    With ``n_devices`` below the world size every process of the world must
    make the call (a sub-group is created); the processes left out get
    ``rank`` -1 and must not use the mesh."""
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if not dist.is_initialized():
        return Mesh((axis_name,), 1, 0, None, dev)
    rank = dist.get_rank()
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if n == 1:
        group = None
    return Mesh((axis_name,), n, rank if rank < n else -1, group, dev)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def axis_index(mesh: Mesh) -> int:
    """This process's index along the mesh axis."""
    if not 0 <= mesh.rank < mesh.size:
        raise RuntimeError("this process is not a member of the mesh")
    return mesh.rank


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, bool as uint8 (what every backend can carry)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks, on every rank (bit-equal on all: each
    backend reduces a chunk on one rank and hands the result round)."""
    if mesh.group is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``x`` concatenated along axis 0 in rank order, on every
    rank (the reference's tiled ``all_gather``)."""
    if mesh.group is None:
        return x
    src = _wire(x)
    out = src.new_empty((mesh.size * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=mesh.group)
    return out.view(x.dtype)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` is ``size`` equal blocks along axis 0; block d goes to rank d,
    and the result holds the blocks received, in rank order (the reference's
    tiled ``all_to_all`` on axis 0)."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"all_to_all needs axis 0 ({x.shape[0]}) divisible by "
                         f"the mesh size ({mesh.size})")
    if mesh.group is None:
        return x
    src = _wire(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out.view(x.dtype)


def shift(x: torch.Tensor, mesh: Mesh, offset: int) -> torch.Tensor:
    """Each rank's ``x`` moved ``offset`` (+1 or -1) ranks along the axis:
    rank r receives rank r - offset's tensor, and zeros where there is no
    such rank (the reference's ``ppermute`` with its edge masked: the axis
    is a line, not a ring)."""
    if offset not in (1, -1):
        raise ValueError(f"shift moves by one rank, got {offset}")
    out = torch.zeros_like(x)
    if mesh.group is None:
        return out
    me = axis_index(mesh)
    src = x.contiguous()
    ops = []
    if 0 <= me + offset < mesh.size:
        ops.append(dist.P2POp(dist.isend, src, me + offset, mesh.group))
    if 0 <= me - offset < mesh.size:
        ops.append(dist.P2POp(dist.irecv, out, me - offset, mesh.group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return out
