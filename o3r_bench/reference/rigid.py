"""Rigid 3D-3D alignment: weighted Umeyama fit + fixed-shape RANSAC (port
of odometry/rigid.py).

RANSAC runs a fixed number of closed-form triad hypotheses at once, scores
them all against all matches, refits on the best inlier set, polishes with
IRLS (Huber) and a Gauss-Newton step with a rotation prior. The hypothesis
indices are the reference's own draw, made on the device
(``hypothesis_indices``: threefry2x32 as ``jax.random`` computes it, from
``odometry.seed`` and the frame index). Nothing here waits for the host:
the Umeyama rotation comes from Horn's quaternion eigenproblem instead of a
library SVD, and the 6x6 solve never reads its status, so a CUDA graph can
hold the whole fit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import se3

_M32 = 0xFFFFFFFF
# threefry2x32's rotation constants, alternating per group of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of ``jax._src.prng`` (20 rounds) on int64
    tensors that hold uint32 values; broadcasts keys against counts.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def hypothesis_indices(seed: int, frame_idx, iters: int, n: int,
                       device: "torch.device | str | None" = None) -> torch.Tensor:
    """(iters, 3) int64 sample indices in [0, n) for one frame's RANSAC:
    the reference's ``jax.random.randint(jax.random.fold_in(
    jax.random.PRNGKey(seed), frame_idx), (iters, 3), 0, n)`` bit for bit,
    under ``jax_threefry_partitionable`` (JAX's default), computed with
    integer tensor ops on the device of ``frame_idx``: a 0-dim integer
    tensor (the packed frame's header index), or an int placed on
    ``device``. Nothing waits for the host."""
    if not 0 <= seed <= _M32 or n < 1:
        raise ValueError(f"seed must be in [0, 2^32) and n >= 1, got {seed}, {n}")
    if not isinstance(frame_idx, torch.Tensor):
        frame_idx = torch.tensor(int(frame_idx), device=device)
    data = frame_idx.to(torch.int64) & _M32
    zero = torch.zeros_like(data)
    # PRNGKey(seed) = (seed >> 32, seed & M); fold_in hashes the count (0, data)
    f0, f1 = _threefry2x32(seed >> 32, seed & _M32, zero, data)
    # split(key): the keys (b0[i], b1[i]) of the counts (0, i), i = 0, 1
    pair = torch.arange(2, device=data.device)
    s0, s1 = _threefry2x32(f0, f1, torch.zeros_like(pair), pair)
    # 32 random bits a value from each key: b0 ^ b1 of the counts (0, c)
    count = torch.arange(iters * 3, device=data.device)
    b0, b1 = _threefry2x32(s0[:, None], s1[:, None], torch.zeros_like(count), count)
    higher, lower = b0 ^ b1
    # randint's double-width modulus, in uint32 arithmetic
    multiplier = (((1 << 16) % n) ** 2 & _M32) % n
    offset = (((higher % n) * multiplier & _M32) + lower % n) & _M32
    return (offset % n).reshape(iters, 3)


# Horn's quaternion form of the rotation, as constant tensors per device:
# N[a, b] = sum_ij cov[i, j] _HORN[i, j, a, b] (Horn 1987, with cov[i, j] =
# sum_n w_n s_ni d_nj), and R[i, j] = sum_ab q_a q_b _QUAT[a, b, i, j] for
# the unit quaternion q = (w, x, y, z)
def _horn_tables() -> Tuple[np.ndarray, np.ndarray]:
    horn = np.zeros((3, 3, 4, 4))
    rows = {  # N's entries as (sign, i, j) terms of cov
        (0, 0): [(1, 0, 0), (1, 1, 1), (1, 2, 2)],
        (0, 1): [(1, 1, 2), (-1, 2, 1)], (0, 2): [(1, 2, 0), (-1, 0, 2)],
        (0, 3): [(1, 0, 1), (-1, 1, 0)],
        (1, 1): [(1, 0, 0), (-1, 1, 1), (-1, 2, 2)],
        (1, 2): [(1, 0, 1), (1, 1, 0)], (1, 3): [(1, 2, 0), (1, 0, 2)],
        (2, 2): [(-1, 0, 0), (1, 1, 1), (-1, 2, 2)], (2, 3): [(1, 1, 2), (1, 2, 1)],
        (3, 3): [(-1, 0, 0), (-1, 1, 1), (1, 2, 2)],
    }
    for (a, b), terms in rows.items():
        for sign, i, j in terms:
            horn[i, j, a, b] += sign
            if a != b:
                horn[i, j, b, a] += sign
    quat = np.zeros((4, 4, 3, 3))
    entries = {  # R's entries as (coefficient, a, b) terms of q_a q_b
        (0, 0): [(1, 0, 0), (1, 1, 1), (-1, 2, 2), (-1, 3, 3)],
        (1, 1): [(1, 0, 0), (-1, 1, 1), (1, 2, 2), (-1, 3, 3)],
        (2, 2): [(1, 0, 0), (-1, 1, 1), (-1, 2, 2), (1, 3, 3)],
        (0, 1): [(2, 1, 2), (-2, 0, 3)], (1, 0): [(2, 1, 2), (2, 0, 3)],
        (0, 2): [(2, 1, 3), (2, 0, 2)], (2, 0): [(2, 1, 3), (-2, 0, 2)],
        (1, 2): [(2, 2, 3), (-2, 0, 1)], (2, 1): [(2, 2, 3), (2, 0, 1)],
    }
    for (i, j), terms in entries.items():
        for coef, a, b in terms:
            quat[a, b, i, j] += coef
    return horn.reshape(9, 16), quat.reshape(16, 9)


_ROTATION_TABLES: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
# squarings of the shifted quaternion matrix: its largest eigenvalue's share
# grows as (mu_2 / mu_1) ** (2 ** k), which this many squarings take below
# float64 rounding for a gap down to 1e-5 of the spectrum
_SQUARINGS = 24


def best_rotation(cov: torch.Tensor) -> torch.Tensor:
    """The rotation R maximizing trace(R^T cov^T) = sum_n w_n d_n . R s_n
    for the cross-covariance ``cov`` (3, 3) = sum_n w_n s_n d_n^T, i.e. the
    Umeyama rotation V diag(1, 1, det(V U^T)) U^T of cov = U S V^T, with
    the reflection fix. Computed without an SVD and without a wait for the
    host: the unit quaternion of R is the eigenvector of the largest
    eigenvalue of Horn's symmetric 4x4 matrix N(cov), found by repeated
    squaring of N + |N|_F I in float64 (a fixed number of products, each
    normalized by its trace), then read off the column of the limit
    projector with the largest diagonal. A zero ``cov`` gives the identity;
    a rank-deficient one (collinear points) some rotation of the optimal
    family, as the SVD does. Returns (3, 3) float32."""
    dev = cov.device
    if dev not in _ROTATION_TABLES:
        horn, quat = _horn_tables()
        _ROTATION_TABLES[dev] = (torch.from_numpy(horn).to(dev),
                                 torch.from_numpy(quat).to(dev))
    horn, quat = _ROTATION_TABLES[dev]
    n_mat = (cov.to(torch.float64).reshape(1, 9) @ horn).reshape(4, 4)
    eye = torch.eye(4, dtype=torch.float64, device=dev)
    # the shift makes every eigenvalue >= 0 (|N|_F bounds them), the tiny
    # floor keeps a zero cov's matrix invertible: I / 4, whose first column wins
    m = n_mat + (torch.linalg.norm(n_mat) + 1e-300) * eye
    for _ in range(_SQUARINGS):
        m = m / torch.trace(m)
        m = m @ m
    diag = torch.diagonal(m)
    col = torch.index_select(m, 1, torch.argmax(diag).reshape(1))[:, 0]
    q = col / torch.linalg.norm(col)
    return ((q[:, None] * q[None, :]).reshape(1, 16) @ quat).reshape(3, 3).to(torch.float32)


def rigid_transform(src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares rigid fit T with dst ~= R @ src + t (Umeyama,
    with the reflection fix; the rotation from ``best_rotation``). src, dst
    (N, 3); weights (N,) >= 0."""
    w = weights.to(torch.float32)
    wn = (w / torch.clamp(w.sum(), min=1e-9))[:, None]
    centroid_s = (src * wn).sum(0)
    centroid_d = (dst * wn).sum(0)
    cov = ((src - centroid_s) * wn).t() @ (dst - centroid_d)
    rot = best_rotation(cov)
    t = centroid_d - rot @ centroid_s
    return se3.from_rt(rot, t)


def refine_rigid_gn(t_init: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor, comp_weight: torch.Tensor,
                    rot_prior: Optional[torch.Tensor] = None,
                    rot_prior_weight: float = 0.0, iters: int = 3,
                    damping: float = 1e-6) -> torch.Tensor:
    """Gauss-Newton polish of a rigid link fit over the se3 tangent:
    minimizes sum_i w_i |C^(1/2) (T(s_i) - d_i)|^2 + rot_prior_weight *
    |Log(R R_prior^T)|^2 (the flight-log attitude constrains the tilt modes a
    near-planar scene cannot; ``comp_weight`` down-weights stereo z)."""
    comp = comp_weight.to(torch.float32)
    w = weights.to(torch.float32)
    eye3 = torch.eye(3, dtype=torch.float32, device=src.device)
    t_cur = t_init
    for _ in range(iters):
        p = se3.transform_points(t_cur, src)
        r = p - dst
        j = torch.cat([eye3.expand(src.shape[0], 3, 3), -se3.hat(p)], dim=-1)
        jw = j * (w[:, None, None] * comp[None, :, None])
        h = torch.einsum("nij,nik->jk", jw, j)
        g = torch.einsum("nij,ni->j", jw, r)
        if rot_prior is not None and rot_prior_weight > 0:
            r_rot = se3.log_so3(t_cur[:3, :3] @ rot_prior.t())
            h = h.clone()
            h[3:, 3:] += rot_prior_weight * eye3
            g = torch.cat([g[:3], g[3:] + rot_prior_weight * r_rot])
        h = h + damping * torch.eye(6, dtype=torch.float32, device=src.device)
        delta = -torch.linalg.solve_ex(h, g, check_errors=False)[0]
        t_cur = se3.retract(t_cur, delta)
    return t_cur


def _triad(p: torch.Tensor) -> torch.Tensor:
    """(I, 3, 3) orthonormal frames (columns) from point triples (I, 3, 3)."""
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    b1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True), min=1e-9)
    c = torch.cross(e1, e2, dim=-1)
    b3 = c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-9)
    b2 = torch.cross(b3, b1, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def _huber_weights(t: torch.Tensor, src, dst, huber: float) -> torch.Tensor:
    r = torch.linalg.norm(se3.transform_points(t, src) - dst, dim=-1)
    return torch.where(r <= huber, 1.0, huber / torch.clamp(r, min=1e-9))


def ransac_rigid(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    samples: torch.Tensor,
    threshold: float = 0.25,
    min_inliers: int = 12,
    weights: Optional[torch.Tensor] = None,
    rot_prior: Optional[torch.Tensor] = None,
    rot_prior_weight: float = 0.0,
    depth_rel_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Robust rigid fit of dst ~= T(src) over masked correspondences.

    ``samples`` (iters, 3): the hypotheses' match indices
    (``hypothesis_indices``). Returns (T (4, 4), inlier_mask (N,),
    inlier_count (), ok ()); when ``ok`` is False (fewer than
    ``min_inliers``) T is the identity and the caller uses its prior.
    """
    n = src.shape[0]
    dev = src.device
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=dev)
    validf = valid.to(torch.float32)

    # closed-form triad hypotheses: exact for their own 3 support points
    s = src[samples]
    d = dst[samples]
    hyp_ok = valid[samples].all(dim=1)
    rot = _triad(d) @ _triad(s).transpose(-1, -2)
    t = d.mean(dim=1) - (rot @ s.mean(dim=1)[..., None])[..., 0]
    proj = src[None] @ rot.transpose(-1, -2) + t[:, None, :]
    err = torch.linalg.norm(proj - dst[None], dim=-1)
    inlier = (err < threshold) & valid[None]
    counts = inlier.sum(dim=1) * hyp_ok.to(torch.int64)
    best_mask = torch.index_select(inlier, 0, torch.argmax(counts).reshape(1))[0]

    t_fit = rigid_transform(src, dst, best_mask.to(torch.float32) * weights)
    for _ in range(3):   # IRLS over the full match set, Huber at threshold
        w = _huber_weights(t_fit, src, dst, threshold) * validf * weights
        t_fit = rigid_transform(src, dst, w)
    w_fin = _huber_weights(t_fit, src, dst, threshold) * validf * weights
    comp = torch.where(torch.arange(3, device=dev) == 2, depth_rel_weight,
                       1.0).to(torch.float32)
    t_fit = refine_rigid_gn(t_fit, src, dst, w_fin, comp, rot_prior=rot_prior,
                            rot_prior_weight=rot_prior_weight)

    proj = se3.transform_points(t_fit, src)
    refined_mask = (torch.linalg.norm(proj - dst, dim=-1) < threshold) & valid
    count = refined_mask.sum()
    ok = count >= min_inliers
    t_out = torch.where(ok, t_fit, torch.eye(4, dtype=torch.float32, device=dev))
    return t_out, refined_mask, count, ok
