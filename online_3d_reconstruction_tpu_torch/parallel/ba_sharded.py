"""Distributed bundle adjustment: sharded Schur assembly (P2, port of
parallel/ba_sharded.py).

The normal-equation accumulations of ba/schur.py are plain sums over the
observation list, so the multi-rank form is simple:

- each rank accumulates (B, C, E, g_p, g_x) over its shard of observations;
- the blocks are reduced over the mesh (kilobytes to a few megabytes, not
  the raw observations);
- the reduced camera system is solved replicated on every rank.

Every rank takes the same accept / reject decision in the Gauss-Newton
loop without a broadcast: the cost is computed from replicated values (the
whole problem, the reduced blocks, which a collective hands to every rank
with equal bits), so the ranks' poses stay bit-equal; the multi-rank test
asserts it.

The port's accumulations are scatter-adds, which on CUDA add with atomics
in no fixed order, and a reduction over ranks sums in another order than
one rank does: a sharded solve agrees with ``solve_ba`` to f32 rounding
(rtol 1e-4), not to bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from online_3d_reconstruction_tpu_torch.ba.problem import BAProblem
from online_3d_reconstruction_tpu_torch.ba.schur import (
    accumulate_normal_blocks,
    add_prior_terms,
    gauss_newton,
)
from online_3d_reconstruction_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    axis_index,
    pad_to_multiple,
    psum,
)

_OBS_FIELDS = ("obs_kf", "obs_lm", "obs_point", "obs_valid", "obs_weight")


def _unit_weights(problem: BAProblem) -> BAProblem:
    """Materialized unit weights, so that every shard has the same fields."""
    if problem.obs_weight is not None:
        return problem
    n = problem.obs_kf.shape[0]
    return problem._replace(obs_weight=torch.ones(
        (n, 3), dtype=torch.float32, device=problem.obs_point.device))


def _pad_observations(problem: BAProblem, n_devices: int) -> BAProblem:
    """The observation list padded to a multiple of ``n_devices``. Padded
    slots are ``obs_valid=False`` (their residual and Jacobian rows are
    zeroed), so the weight's pad value never matters; 1.0 keeps a diagonal
    meaning."""
    problem = _unit_weights(problem)
    n = problem.obs_kf.shape[0]
    pad = pad_to_multiple(n, n_devices) - n
    if pad == 0:
        return problem

    def padded(x, value=0):
        tail = x.new_full((pad,) + x.shape[1:], value)
        return torch.cat([x, tail])

    return problem._replace(
        obs_kf=padded(problem.obs_kf), obs_lm=padded(problem.obs_lm),
        obs_point=padded(problem.obs_point), obs_valid=padded(problem.obs_valid, False),
        obs_weight=padded(problem.obs_weight, 1.0))


def _observation_shard(problem: BAProblem, rows: slice) -> BAProblem:
    """``problem`` with the observations ``rows`` only and no priors (the
    prior terms are added once, after the reduction)."""
    return problem._replace(priors=None, prior_valid=None,
                            **{f: getattr(problem, f)[rows] for f in _OBS_FIELDS})


def _accumulate(poses, landmarks, problem: BAProblem, mesh: Mesh, huber_delta: float):
    """This rank's normal blocks (B, C, E, g_p, g_x): the sums over its
    contiguous share of the (padded) observation list, not yet reduced."""
    per = problem.obs_kf.shape[0] // mesh.size
    me = axis_index(mesh)
    local = _observation_shard(problem, slice(me * per, (me + 1) * per))
    return accumulate_normal_blocks(poses, landmarks, local, huber_delta)


def _accumulate_slots(poses, landmarks, problem: BAProblem, mesh: Mesh,
                      slot_major: int, huber_delta: float):
    """This rank's normal blocks of the slot-sharded solve: its W / n pose
    slots with their ``slot_major`` observations each, re-indexed
    0..w_local-1. Returns (B (w_local, 6, 6), C (L, 3, 3) partial sums,
    E (w_local, L, 6, 3), g_p (w_local, 6), g_x (L, 3) partial sums)."""
    w_local = poses.shape[0] // mesh.size
    me = axis_index(mesh)
    rows = slice(me * w_local * slot_major, (me + 1) * w_local * slot_major)
    local = _observation_shard(problem, rows)._replace(
        obs_kf=torch.arange(w_local, device=poses.device).repeat_interleave(slot_major))
    return accumulate_normal_blocks(poses[me * w_local:(me + 1) * w_local], landmarks,
                                    local, huber_delta, slot_major=slot_major)


def _split(flat: torch.Tensor, like) -> list:
    """``flat`` cut back into tensors of the shapes of ``like``."""
    parts = torch.split(flat, [t.numel() for t in like])
    return [p.reshape(t.shape) for p, t in zip(parts, like)]


def solve_ba_slot_sharded(
    problem: BAProblem,
    mesh: Mesh,
    slot_major: int,
    iters: int = 5,
    damping: float = 1e-4,
    huber_delta: float = 0.5,
    anchor_first: bool = True,
    prior_position_weight: float = 0.0,
    prior_rotation_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KEYFRAME-sharded distributed Schur solve for slot-major problems.

    The observation-sharded form (``solve_ba_sharded``) splits the flat
    observation list, which destroys the slot-major layout and forces the
    generic accumulation. Here each rank takes a contiguous block of W / n
    pose SLOTS (with their ``slot_major`` observations each), runs the
    slot-major accumulation locally, then per Gauss-Newton step:

    - C, g_x (landmark blocks) are summed with one ``all_reduce``;
    - B, g_p, E (per-pose blocks) are concatenated with one ``all_gather``
      along the slot axis (each rank owned disjoint slots);
    - the reduced 6W x 6W camera system is solved replicated.

    Wire floats per step: L * 12 (reduce) + W * (36 + 6 + L * 18) (gather).
    Requires W % n == 0 and N == W * slot_major.
    """
    w_count = problem.poses.shape[0]
    n_obs = problem.obs_kf.shape[0]
    if w_count % mesh.size or n_obs != w_count * slot_major:
        raise ValueError(
            f"slot-sharded BA needs W ({w_count}) % n_dev ({mesh.size}) == 0 and "
            f"N ({n_obs}) == W * slot_major ({slot_major})")
    problem = _unit_weights(problem)
    l_count = problem.landmarks.shape[0]

    def blocks(poses, landmarks):
        b, c, e, g_p, g_x = _accumulate_slots(poses, landmarks, problem, mesh,
                                              slot_major, huber_delta)
        w_local = b.shape[0]
        c, g_x = _split(psum(torch.cat([c.reshape(-1), g_x.reshape(-1)]), mesh),
                        (c, g_x))
        rows = all_gather(torch.cat([b.reshape(w_local, 36), g_p,
                                     e.reshape(w_local, l_count * 18)], dim=1), mesh)
        b = rows[:, :36].reshape(w_count, 6, 6)
        g_p = rows[:, 36:42]
        e = rows[:, 42:].reshape(w_count, l_count, 6, 3)
        b, g_p = add_prior_terms(poses, problem, b, g_p, prior_position_weight,
                                 prior_rotation_weight)
        return b, c, e, g_p, g_x

    return gauss_newton(problem, blocks, iters, damping, huber_delta, anchor_first,
                        prior_position_weight, prior_rotation_weight)


def solve_ba_sharded(
    problem: BAProblem,
    mesh: Mesh,
    iters: int = 5,
    damping: float = 1e-4,
    huber_delta: float = 0.5,
    anchor_first: bool = True,
    prior_position_weight: float = 0.0,
    prior_rotation_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drop-in distributed version of ``ba.schur.solve_ba``.

    Same signature plus a mesh: the observations are sharded over the mesh
    axis and the normal blocks reduced by ONE ``all_reduce`` per
    Gauss-Newton step (B, C, E, g_p, g_x flattened into one buffer: five
    collectives would be five launches and five waits). Absolute-prior
    terms are unary in the replicated poses, so they are added once after
    the reduction, not inside the shards. Returns (poses, landmarks,
    cost_trace); the given problem's own observation count is kept.
    """
    padded = _pad_observations(problem, mesh.size)

    def blocks(poses, landmarks):
        local = _accumulate(poses, landmarks, padded, mesh, huber_delta)
        flat = psum(torch.cat([t.reshape(-1) for t in local]), mesh)
        b, c, e, g_p, g_x = _split(flat, local)
        b, g_p = add_prior_terms(poses, problem, b, g_p, prior_position_weight,
                                 prior_rotation_weight)
        return b, c, e, g_p, g_x

    return gauss_newton(problem, blocks, iters, damping, huber_delta, anchor_first,
                        prior_position_weight, prior_rotation_weight)
