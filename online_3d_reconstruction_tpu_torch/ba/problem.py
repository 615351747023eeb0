"""Bundle-adjustment problem container + residuals/Jacobians (port of
ba/problem.py).

The residual is the camera-frame point consistency

    r_kj = R_k^T (X_j - t_k) - p_kj

for keyframe pose T_k = (R_k, t_k) (world-from-camera), landmark X_j (world)
and observation p_kj (the feature's disparity-lifted camera-frame point).
Jacobians are analytic, with a left-multiplicative pose update
T <- exp([rho, phi]) T (se3.retract):

    d r / d rho = -R^T          d r / d phi = R^T [X]_x
    d r / d X   =  R^T

Everything is a fixed-capacity flat observation list (kf index, landmark
index, point, mask). The reference gathers per-observation poses and
landmarks with one-hot matmuls (a TPU stand-in for gathers); here they are
plain index gathers, which give the same values. Every product is full f32
(TF32 is off, see ``runtime.pipeline.resolve_device``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.geometry import se3


class BAProblem(NamedTuple):
    poses: torch.Tensor       # (W, 4, 4) initial world-from-camera keyframe poses
    landmarks: torch.Tensor   # (L, 3) initial world landmark positions
    lm_valid: torch.Tensor    # (L,) bool
    obs_kf: torch.Tensor      # (N,) int64 keyframe index per observation
    obs_lm: torch.Tensor      # (N,) int64 landmark index per observation
    obs_point: torch.Tensor   # (N, 3) float32 observed camera-frame point
    obs_valid: torch.Tensor   # (N,) bool
    # optional absolute pose priors (flight-log GPS/attitude): a weak unary
    # prior residual per keyframe; None disables the terms
    priors: Optional[torch.Tensor] = None       # (W, 4, 4)
    prior_valid: Optional[torch.Tensor] = None  # (W,) bool
    # optional per-observation information in the camera frame: (N, 3)
    # diagonal weights 1/sigma^2 or (N, 3, 3) full matrices Sigma^-1;
    # None = unit weights
    obs_weight: Optional[torch.Tensor] = None   # (N, 3) or (N, 3, 3)


_INDEX_FIELDS = ("obs_kf", "obs_lm")
_MASK_FIELDS = ("lm_valid", "obs_valid", "prior_valid")


def problem_from_numpy(problem, device: "torch.device | str") -> BAProblem:
    """A ``BAProblem`` of the port, on ``device``, from any object with the
    same fields holding array-likes (numpy arrays, or the reference's
    arrays, which numpy reads): indices become int64, masks bool, the rest
    float32; an absent optional field stays None."""
    fields = {}
    for name in BAProblem._fields:
        value = getattr(problem, name, None)
        if value is None:
            fields[name] = None
            continue
        arr = np.asarray(value)
        if name in _INDEX_FIELDS:
            arr = arr.astype(np.int64)
        elif name in _MASK_FIELDS:
            arr = arr.astype(bool)
        else:
            arr = arr.astype(np.float32)
        fields[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return BAProblem(**fields)


def prior_residuals(poses: torch.Tensor, problem: BAProblem
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unary prior residuals per keyframe: (r_pos (W, 3), r_rot (W, 3)).

    r_pos = t_k - t_prior;  r_rot = Log(R_k R_prior^T) (world-frame axis-angle).
    """
    r_pos = poses[:, :3, 3] - problem.priors[:, :3, 3]
    rel = poses[:, :3, :3] @ problem.priors[:, :3, :3].transpose(-1, -2)
    r_rot = se3.log_so3(rel)
    ok = problem.prior_valid[:, None]
    return torch.where(ok, r_pos, 0.0), torch.where(ok, r_rot, 0.0)


def prior_jacobians(poses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobians of the prior residuals w.r.t. the left-multiplicative pose
    tangent [rho, phi]:  t' ~= t + rho + phi x t  and  R' ~= exp(phi^) R, so

        d r_pos / d[rho, phi] = [I, -[t]_x]      (3, 6)
        d r_rot / d[rho, phi] ~= [0,  I]         (small-angle)
    """
    w = poses.shape[0]
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device).expand(w, 3, 3)
    t_hat = se3.hat(poses[:, :3, 3])
    j_pos = torch.cat([eye, -t_hat], dim=-1)                 # (W, 3, 6)
    j_rot = torch.cat([torch.zeros_like(eye), eye], dim=-1)
    return j_pos, j_rot


def gather_obs(poses: torch.Tensor, landmarks: torch.Tensor, problem: BAProblem
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-observation (rot (N, 3, 3), t (N, 3), x (N, 3)); the indices are
    in range by construction."""
    per_obs = poses[problem.obs_kf]
    return per_obs[:, :3, :3], per_obs[:, :3, 3], landmarks[problem.obs_lm]


def residuals(poses: torch.Tensor, landmarks: torch.Tensor,
              problem: BAProblem) -> torch.Tensor:
    """(N, 3) residuals r = R^T (X - t) - p (invalid slots zeroed)."""
    rot, t, x = gather_obs(poses, landmarks, problem)
    pred = torch.einsum("nji,nj->ni", rot, x - t)
    r = pred - problem.obs_point
    return torch.where(problem.obs_valid[:, None], r, 0.0)


def jacobians(poses: torch.Tensor, landmarks: torch.Tensor, problem: BAProblem
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic per-observation Jacobians: (j_pose (N, 3, 6), j_point
    (N, 3, 3)); the pose tangent is ordered [rho (translation), phi
    (rotation)] as in se3.exp."""
    rot, _, x = gather_obs(poses, landmarks, problem)
    rot_t = rot.transpose(-1, -2)                 # (N, 3, 3) = R^T
    j_pose = torch.cat([-rot_t, rot_t @ se3.hat(x)], dim=-1)   # (N, 3, 6)
    mask = problem.obs_valid[:, None, None]
    return torch.where(mask, j_pose, 0.0), torch.where(mask, rot_t, 0.0)


def weighted_sqnorm(r: torch.Tensor, problem: BAProblem) -> torch.Tensor:
    """(N,) squared residual norm in whitened units r^T W r (plain |r|^2 in
    metres^2 without ``obs_weight``)."""
    if problem.obs_weight is None:
        return (r * r).sum(-1)
    if problem.obs_weight.dim() == 3:
        wr = torch.einsum("nij,nj->ni", problem.obs_weight, r)
        return (r * wr).sum(-1)
    return (problem.obs_weight * r * r).sum(-1)


def stereo_obs_weights(points: torch.Tensor, depth_coeff: float,
                       lateral_coeff: float, min_depth: float = 1.0
                       ) -> torch.Tensor:
    """(N, 3) DIAGONAL information weights from the stereo noise model:
    sigma_z = z^2 * depth_coeff, sigma_x = sigma_y = z * lateral_coeff,
    weights 1/sigma^2. The legacy model; ``stereo_obs_information`` keeps
    the ray-direction x/y<->z coupling this one ignores."""
    z = torch.clamp(points[..., 2].abs(), min=min_depth)
    w_lat = 1.0 / (lateral_coeff * z) ** 2
    w_z = 1.0 / (depth_coeff * z * z) ** 2
    return torch.stack([w_lat, w_lat, w_z], dim=-1)


class StereoNoiseModel(NamedTuple):
    """Stereo measurement-noise description; the pipeline builds one from
    the rig and the BAConfig sigmas."""

    fx: float
    fy: float
    baseline: float
    sigma_px: float         # 1-sigma keypoint localization noise (pixels)
    sigma_disparity: float  # 1-sigma disparity noise (pixels)


def stereo_obs_information(points: torch.Tensor, model: StereoNoiseModel,
                           min_depth: float = 1.0) -> torch.Tensor:
    """(N, 3, 3) FULL information matrices Sigma^-1 per observation.

    The stereo lift p = ((u-cx) z / fx, (v-cy) z / fy, z) with z = fx b / d
    maps independent pixel noise (sigma_u, sigma_v, sigma_d) through
    J = d p / d (u, v, d), whose inverse is closed-form:

        J^-1 = [[fx/z, 0, -fx x / z^2],
                [0, fy/z, -fy y / z^2],
                [0, 0,    -fx b / z^2]]

    With M = diag(1/sigma) J^-1 the information is W = M^T M.
    """
    x = points[..., 0]
    y = points[..., 1]
    z = torch.clamp(points[..., 2].abs(), min=min_depth)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(z)
    r1 = torch.stack([model.fx * inv_z / model.sigma_px, zero,
                      -model.fx * x * inv_z2 / model.sigma_px], dim=-1)
    r2 = torch.stack([zero, model.fy * inv_z / model.sigma_px,
                      -model.fy * y * inv_z2 / model.sigma_px], dim=-1)
    r3 = torch.stack([zero, zero,
                      -model.fx * model.baseline * inv_z2 / model.sigma_disparity],
                     dim=-1)
    m = torch.stack([r1, r2, r3], dim=-2)          # (N, 3, 3)
    return m.transpose(-1, -2) @ m                 # M^T M


def total_cost(poses: torch.Tensor, landmarks: torch.Tensor,
               problem: BAProblem, huber_delta: float = 0.0) -> torch.Tensor:
    """Scalar robust cost 0.5 sum rho(|r|_W^2); huber_delta <= 0 is pure L2.
    The norm is whitened when the problem carries ``obs_weight`` (delta in
    sigma units), else metres."""
    sq = weighted_sqnorm(residuals(poses, landmarks, problem), problem)
    if huber_delta > 0:
        norm = torch.sqrt(torch.clamp(sq, min=1e-18))
        lin = huber_delta * (2.0 * norm - huber_delta)
        cost = torch.where(norm <= huber_delta, sq, lin)
    else:
        cost = sq
    return 0.5 * torch.where(problem.obs_valid, cost, 0.0).sum()


def huber_weights(r: torch.Tensor, delta: float,
                  problem: "BAProblem | None" = None) -> torch.Tensor:
    """(N,) IRLS weights for the Huber loss on the (whitened) residual norm."""
    if problem is not None:
        norm = torch.sqrt(torch.clamp(weighted_sqnorm(r, problem), min=1e-24))
    else:
        norm = torch.linalg.norm(r, dim=-1)
    return torch.where(norm <= delta, 1.0, delta / torch.clamp(norm, min=1e-12))
