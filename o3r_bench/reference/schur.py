"""Damped Gauss-Newton with a dense-block Schur complement — the BA solver
(port of ba/schur.py).

The normal equations H = [[B, E], [E^T, C]] are assembled densely in the
block structure: per-landmark 3x3 blocks C_j (inverted in closed form), the
pose-landmark coupling E as a dense (W, L, 6, 3) tensor, and the reduced
camera system

    S = B - E C^{-1} E^T        (6W x 6W, dense)
    S dp = -g_p + E C^{-1} g_x
    dx_j = C_j^{-1} (-g_x_j - E_{.j}^T dp)

solved by Cholesky. The reference accumulates with one-hot matmuls and a
per-slot one-hot scan (TPU stand-ins for scatters); here the accumulations
are ``index_add_`` scatter-adds. Where one index target collects many
observations (the per-pose and per-landmark sums of the generic path), CUDA
adds them with atomics in an order that varies from run to run, so the last
float bits do too (relative ~1e-7 per sum); the slot-major path of the
window scatters each (slot, landmark) pair once and sums over slots with a
plain reduction, so it is deterministic.

Gauge: the first pose's rows/columns of S are replaced by identity (exact
anchor), the reference's fixed-first-keyframe convention.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .problem import (
    BAProblem,
    huber_weights,
    jacobians,
    prior_jacobians,
    prior_residuals,
    residuals,
    total_cost,
)
from . import se3


def _scatter_sum(index: torch.Tensor, values: torch.Tensor, size: int) -> torch.Tensor:
    """(size, ...) sums of ``values`` rows grouped by ``index``."""
    out = torch.zeros((size,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, index, values)


def accumulate_normal_blocks(poses, landmarks, problem: BAProblem,
                             huber_delta: float,
                             prior_position_weight: float = 0.0,
                             prior_rotation_weight: float = 0.0,
                             slot_major: int = 0):
    """One pass over the observation list -> (B (W, 6, 6), C (L, 3, 3),
    E (W, L, 6, 3), g_p (W, 6), g_x (L, 3)).

    Absolute pose-prior terms are added to B and g_p when the problem
    carries priors and a weight is positive. ``slot_major`` > 0 declares
    the layout of ba/device_tracks.py: observation n belongs to pose slot
    n // slot_major (exactly ``slot_major`` per slot), which selects the
    analytic per-slot accumulation.
    """
    w_count = poses.shape[0]
    l_count = landmarks.shape[0]
    r = residuals(poses, landmarks, problem)              # (N, 3)
    w = problem.obs_valid.to(torch.float32)
    if huber_delta > 0:
        w = w * huber_weights(r, huber_delta, problem)
    if slot_major > 0:
        return _accumulate_slot_major(
            poses, landmarks, problem, r, w, slot_major,
            prior_position_weight, prior_rotation_weight)
    j_pose, j_point = jacobians(poses, landmarks, problem)
    # row weight = validity * IRLS scalar * observation information:
    # J^T W J with W = w * W_obs (diagonal (N, 3) or full (N, 3, 3))
    if problem.obs_weight is not None and problem.obs_weight.dim() == 3:
        w_mat = w[:, None, None] * problem.obs_weight     # (N, 3, 3)
        jp_w = w_mat @ j_pose                             # (N, 3, 6) = W J
        jx_w = w_mat @ j_point
    else:
        wc = w[:, None]
        if problem.obs_weight is not None:
            wc = wc * problem.obs_weight                  # (N, 3)
        jp_w = j_pose * wc[:, :, None]
        jx_w = j_point * wc[:, :, None]
    hp = jp_w.transpose(-1, -2) @ j_pose                  # (N, 6, 6)
    hx = jx_w.transpose(-1, -2) @ j_point                 # (N, 3, 3)
    e_obs = jp_w.transpose(-1, -2) @ j_point              # (N, 6, 3)
    gp_obs = torch.einsum("nij,ni->nj", jp_w, r)          # (N, 6)
    gx_obs = torch.einsum("nij,ni->nj", jx_w, r)          # (N, 3)

    b_blocks = _scatter_sum(problem.obs_kf, hp, w_count)
    c_blocks = _scatter_sum(problem.obs_lm, hx, l_count)
    g_p = _scatter_sum(problem.obs_kf, gp_obs, w_count)
    g_x = _scatter_sum(problem.obs_lm, gx_obs, l_count)
    b_blocks, g_p = add_prior_terms(poses, problem, b_blocks, g_p,
                                     prior_position_weight,
                                     prior_rotation_weight)
    pair = problem.obs_kf * l_count + problem.obs_lm
    e_dense = _scatter_sum(pair, e_obs, w_count * l_count).reshape(
        w_count, l_count, 6, 3)
    return b_blocks, c_blocks, e_dense, g_p, g_x


def add_prior_terms(poses, problem, b_blocks, g_p,
                     prior_position_weight, prior_rotation_weight):
    """Add the unary flight-log prior terms to (B, g_p) when enabled."""
    use_priors = problem.priors is not None and (
        prior_position_weight > 0 or prior_rotation_weight > 0)
    if not use_priors:
        return b_blocks, g_p
    r_pos, r_rot = prior_residuals(poses, problem)
    j_pos, j_rot = prior_jacobians(poses)
    wv = problem.prior_valid.to(torch.float32)
    wp = prior_position_weight * wv
    wr = prior_rotation_weight * wv
    b_blocks = b_blocks + (
        wp[:, None, None] * (j_pos.transpose(-1, -2) @ j_pos)
        + wr[:, None, None] * (j_rot.transpose(-1, -2) @ j_rot))
    g_p = g_p + (
        wp[:, None] * torch.einsum("wij,wi->wj", j_pos, r_pos)
        + wr[:, None] * torch.einsum("wij,wi->wj", j_rot, r_rot))
    return b_blocks, g_p


def _accumulate_slot_major(poses, landmarks, problem: BAProblem, r, w, k: int,
                           prior_position_weight, prior_rotation_weight):
    """Slot-major accumulation in analytic per-observation form.

    Observation n belongs to pose slot n // k. Within a slot R is constant
    and J_pose = R^T [-I | hat(X)], J_point = R^T, so every block is an
    elementwise combination of G = R A R^T (A = IRLS-weighted information),
    u = R A r and cross products with X:

        B  += [[G, -G hat(X)], [(G hat(X))^T, hat(X)^T G hat(X)]]
        C  +=  G          E += [-G; (G hat(X))^T]
        g_p += [-u; u x X]                g_x += u

    Per-pose sums are reshaped sums. The per-landmark payload [G | u |
    G hat(X)] (21 floats) is scattered to (slot, landmark) pairs, and C,
    g_x are its sums over slots — the reference's per-slot one-hot scan
    without the one-hots.
    """
    w_count = poses.shape[0]
    l_count = landmarks.shape[0]
    n = problem.obs_kf.shape[0]
    if n != w_count * k:
        raise ValueError(f"slot_major={k} needs W * k = {w_count * k} "
                         f"observations, got {n}")
    eye3 = torch.eye(3, dtype=torch.float32, device=poses.device)
    if problem.obs_weight is not None and problem.obs_weight.dim() == 3:
        a_mat = w[:, None, None] * problem.obs_weight          # (N, 3, 3)
    elif problem.obs_weight is not None:
        a_mat = (w[:, None] * problem.obs_weight)[:, :, None] * eye3
    else:
        a_mat = w[:, None, None] * eye3

    rot = poses[:, :3, :3]                                     # (W, 3, 3)
    a_slot = a_mat.reshape(w_count, k, 3, 3)
    g_obs = rot[:, None] @ a_slot @ rot[:, None].transpose(-1, -2)  # (W, K, 3, 3)
    ar = torch.einsum("nij,nj->ni", a_mat, r).reshape(w_count, k, 3)
    u_obs = torch.einsum("wab,wkb->wka", rot, ar)              # (W, K, 3)
    x = landmarks[problem.obs_lm].reshape(w_count, k, 3)

    # G hat(X): row i is cross(G[i, :], X); hat(X)^T M has columns
    # cross(M[:, j], X)
    xb = x[:, :, None, :].expand_as(g_obs)
    gh = torch.linalg.cross(g_obs, xb, dim=-1)                 # (W, K, 3, 3)
    hthg = torch.linalg.cross(gh.transpose(-1, -2), xb, dim=-1).transpose(-1, -2)
    hu = torch.linalg.cross(u_obs, x, dim=-1)                  # u x X

    sg = g_obs.sum(1)                                          # (W, 3, 3)
    sgh = gh.sum(1)
    b_blocks = torch.cat([
        torch.cat([sg, -sgh], dim=-1),
        torch.cat([-sgh.transpose(-1, -2), hthg.sum(1)], dim=-1),
    ], dim=-2)                                                 # (W, 6, 6)
    g_p = torch.cat([-u_obs.sum(1), hu.sum(1)], dim=-1)        # (W, 6)

    payload = torch.cat([g_obs.reshape(w_count, k, 9), u_obs,
                         gh.reshape(w_count, k, 9)], dim=-1).reshape(n, 21)
    slot = torch.arange(w_count, device=poses.device).repeat_interleave(k)
    acc = _scatter_sum(slot * l_count + problem.obs_lm, payload,
                       w_count * l_count).reshape(w_count, l_count, 21)
    c_blocks = acc[..., :9].sum(0).reshape(l_count, 3, 3)
    g_x = acc[..., 9:12].sum(0)
    g_wl = acc[..., :9].reshape(w_count, l_count, 3, 3)
    gh_wl = acc[..., 12:].reshape(w_count, l_count, 3, 3)
    e_dense = torch.cat([-g_wl, gh_wl.transpose(-1, -2)], dim=-2)  # (W, L, 6, 3)

    b_blocks, g_p = add_prior_terms(poses, problem, b_blocks, g_p,
                                     prior_position_weight,
                                     prior_rotation_weight)
    return b_blocks, c_blocks, e_dense, g_p, g_x


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate (callers damp the
    diagonal, so the determinant stays away from zero)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def schur_solve(b_blocks, c_blocks, e_dense, g_p, g_x,
                damping: float, anchor_first: bool):
    """Reduced-camera-system solve. Returns (dp (W, 6), dx (L, 3)).

    A reduced system that is not positive definite yields NaN steps (as the
    reference's Cholesky does), which the caller's cost guard rejects; the
    factorization reports failure in a device tensor, so nothing here waits
    for the device.
    """
    w_count = b_blocks.shape[0]
    l_count = c_blocks.shape[0]
    dev = b_blocks.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    c_inv = inv3x3(c_blocks + damping * eye3 + 1e-8 * eye3)   # (L, 3, 3)
    ec = e_dense @ c_inv                                      # (W, L, 6, 3)
    # S[a, j, b, m] = delta_ab (B + lambda I) - sum_l (E C^-1)_{al} E_{bl}^T:
    # one (6W, 3L) x (3L, 6W) product
    ec_mat = ec.permute(0, 2, 1, 3).reshape(6 * w_count, 3 * l_count)
    e_mat = e_dense.permute(0, 2, 1, 3).reshape(6 * w_count, 3 * l_count)
    s_mat = -(ec_mat @ e_mat.t()).reshape(w_count, 6, w_count, 6)
    diag = torch.arange(w_count, device=dev)
    s_mat[diag, :, diag, :] += b_blocks + damping * eye6
    rhs = -g_p + (ec_mat @ g_x.reshape(-1)).reshape(w_count, 6)

    if anchor_first:
        s_mat[0] = 0.0
        s_mat[:, :, 0] = 0.0
        s_mat[0, :, 0] = eye6
        rhs[0] = 0.0

    n = 6 * w_count
    chol, info = torch.linalg.cholesky_ex(s_mat.reshape(n, n))
    dp = torch.cholesky_solve(rhs.reshape(n, 1), chol).reshape(w_count, 6)
    dp = torch.where(info == 0, dp, float("nan"))

    # back-substitute landmarks: dx_j = C_j^{-1} (-g_x - E^T dp)
    et_dp = (e_mat.t() @ dp.reshape(-1)).reshape(l_count, 3)
    dx = torch.einsum("lij,lj->li", c_inv, -g_x - et_dp)
    return dp, dx


def gauss_newton(problem: BAProblem, blocks_fn, iters: int, damping: float,
                 huber_delta: float, anchor_first: bool,
                 prior_position_weight: float, prior_rotation_weight: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``iters`` damped-GN steps on ``problem``, the normal blocks of each
    step (prior terms included) coming from ``blocks_fn(poses, landmarks)``:
    the one loop of ``solve_ba`` and of the sharded solves of
    parallel/ba_sharded.py. Returns (poses, landmarks, cost_trace).

    One cost evaluation per step; a step that does not lower the cost is
    rejected, and the decision is a device tensor (``torch.where``), so the
    loop never waits for the device.
    """
    use_priors = problem.priors is not None and (
        prior_position_weight > 0 or prior_rotation_weight > 0)

    def cost_fn(poses, landmarks):
        c = total_cost(poses, landmarks, problem, huber_delta)
        if use_priors:
            r_pos, r_rot = prior_residuals(poses, problem)
            c = c + 0.5 * (prior_position_weight * (r_pos * r_pos).sum()
                           + prior_rotation_weight * (r_rot * r_rot).sum())
        return c

    poses, landmarks = problem.poses, problem.landmarks
    cost = cost_fn(poses, landmarks)
    trace = [cost]
    for _ in range(iters):
        dp, dx = schur_solve(*blocks_fn(poses, landmarks), damping, anchor_first)
        new_poses = se3.retract(poses, dp)
        new_landmarks = torch.where(problem.lm_valid[:, None], landmarks + dx,
                                    landmarks)
        # reject a diverging step (cost-increase guard, LM-style)
        cost_after = cost_fn(new_poses, new_landmarks)
        accept = cost_after < cost
        poses = torch.where(accept, new_poses, poses)
        landmarks = torch.where(accept, new_landmarks, landmarks)
        cost = torch.where(accept, cost_after, cost)
        trace.append(cost)
    return poses, landmarks, torch.stack(trace)


def solve_ba(problem: BAProblem, iters: int = 5, damping: float = 1e-4,
             huber_delta: float = 0.5, anchor_first: bool = True,
             prior_position_weight: float = 0.0,
             prior_rotation_weight: float = 0.0,
             slot_major: int = 0,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run ``iters`` damped-GN steps. Returns (poses, landmarks, cost_trace).

    cost_trace has iters+1 entries (the cost before each step and after the
    last); see ``gauss_newton`` for the step. ``slot_major``: see
    ``accumulate_normal_blocks``.
    """
    def blocks(poses, landmarks):
        return accumulate_normal_blocks(
            poses, landmarks, problem, huber_delta,
            prior_position_weight, prior_rotation_weight, slot_major=slot_major)

    return gauss_newton(problem, blocks, iters, damping, huber_delta, anchor_first,
                        prior_position_weight, prior_rotation_weight)
