"""SE(3) rigid-transform utilities (port of geometry/se3.py).

A pose is a (4, 4) float32 tensor (world-from-camera unless noted); tangent
vectors are (6,) with translation first, xi = [rho, phi]. Every product is
full f32: the package turns TF32 off for CUDA matmuls (see
``runtime.pipeline.resolve_device``), the counterpart of the reference's
``Precision.HIGHEST``. No function here waits for the host: a transform is
built from an identity by tensor writes (a Python scalar stored into one
element of a CUDA tensor is a blocking upload) and ``log`` solves without
reading a status, so a CUDA graph can hold them.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye4(batch, like: torch.Tensor) -> torch.Tensor:
    """(*batch, 4, 4) identities of ``like``'s dtype and device."""
    eye = torch.eye(4, dtype=like.dtype, device=like.device)
    return eye.expand(*batch, 4, 4).clone()


def from_rt(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """4x4 transform from a 3x3 rotation and a 3-vector translation."""
    out = _eye4((), rotation)
    out[:3, :3] = rotation
    out[:3, 3] = translation.reshape(3)
    return out


def rotation(transform: torch.Tensor) -> torch.Tensor:
    return transform[..., :3, :3]


def translation(transform: torch.Tensor) -> torch.Tensor:
    return transform[..., :3, 3]


def inverse(transform: torch.Tensor) -> torch.Tensor:
    rot_t = rotation(transform).transpose(-1, -2)
    inv_t = -(rot_t @ translation(transform)[..., None])[..., 0]
    out = _eye4(transform.shape[:-2], transform)
    out[..., :3, :3] = rot_t
    out[..., :3, 3] = inv_t
    return out


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a then-applied-to b, i.e. the matrix product a @ b."""
    return a @ b


def transform_points(transform: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to an (..., N, 3) point array."""
    return (points @ rotation(transform).transpose(-1, -2)
            + translation(transform)[..., None, :])


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _series_coeffs(theta_sq: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3), series near 0."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS))
    safe = theta_sq > _EPS
    a = torch.where(safe, torch.sin(theta) / theta, 1.0 - theta_sq / 6.0)
    b = torch.where(safe, (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=_EPS),
                    0.5 - theta_sq / 24.0)
    c = torch.where(safe, (theta - torch.sin(theta))
                    / torch.clamp(theta_sq * theta, min=_EPS),
                    1.0 / 6.0 - theta_sq / 120.0)
    return a, b, c


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, series-safe at theta -> 0."""
    a, b, _ = _series_coeffs((phi * phi).sum(-1))
    skew = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(skew.shape)
    return eye + a[..., None, None] * skew + b[..., None, None] * (skew @ skew)


def log_so3(rot: torch.Tensor) -> torch.Tensor:
    """Inverse of exp_so3 (principal branch, |theta| < pi)."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    vee = torch.stack([rot[..., 2, 1] - rot[..., 1, 2],
                       rot[..., 0, 2] - rot[..., 2, 0],
                       rot[..., 1, 0] - rot[..., 0, 1]], dim=-1)
    scale = torch.where(theta > 1e-5, theta / (2.0 * torch.sin(theta)),
                        0.5 + theta * theta / 12.0)
    return scale[..., None] * vee


def _v_matrix(phi: torch.Tensor) -> torch.Tensor:
    _, b, c = _series_coeffs((phi * phi).sum(-1))
    skew = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(skew.shape)
    return eye + b[..., None, None] * skew + c[..., None, None] * (skew @ skew)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: xi = [rho(3), phi(3)] -> 4x4 transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    out = _eye4(xi.shape[:-1], xi)
    out[..., :3, :3] = exp_so3(phi)
    out[..., :3, 3] = (_v_matrix(phi) @ rho[..., None])[..., 0]
    return out


def log(transform: torch.Tensor) -> torch.Tensor:
    """se(3) logarithm: 4x4 transform -> [rho, phi]."""
    phi = log_so3(rotation(transform))
    rho = torch.linalg.solve_ex(_v_matrix(phi), translation(transform)[..., None],
                                check_errors=False)[0][..., 0]
    return torch.cat([rho, phi], dim=-1)


def retract(transform: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update: exp(xi) @ T."""
    return exp(xi) @ transform


def identity(device: "torch.device | str" = "cuda") -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


