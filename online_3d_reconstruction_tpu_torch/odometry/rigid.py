"""Rigid 3D-3D alignment: weighted Umeyama fit + fixed-shape RANSAC (port
of odometry/rigid.py).

RANSAC runs a fixed number of closed-form triad hypotheses at once, scores
them all against all matches, refits on the best inlier set, polishes with
IRLS (Huber) and a Gauss-Newton step with a rotation prior. The hypothesis
indices come from ``hypothesis_indices``: torch cannot reproduce
``jax.random``'s numbers, so that one function owns the draw (tests replace
it to inject the reference's indices).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from online_3d_reconstruction_tpu_torch.geometry import se3


def hypothesis_indices(seed: int, frame_idx: int, iters: int, n: int,
                       device: "torch.device | str") -> torch.Tensor:
    """(iters, 3) int64 sample indices in [0, n) for one frame's RANSAC,
    drawn on the CPU from a generator seeded by (seed, frame index), so the
    CPU and CUDA runs draw the same hypotheses."""
    gen = torch.Generator().manual_seed(seed * 1_000_003 + frame_idx)
    return torch.randint(0, n, (iters, 3), generator=gen).to(device)


def rigid_transform(src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares rigid fit T with dst ~= R @ src + t (Umeyama,
    with the reflection fix). src, dst (N, 3); weights (N,) >= 0."""
    w = weights.to(torch.float32)
    wn = (w / torch.clamp(w.sum(), min=1e-9))[:, None]
    centroid_s = (src * wn).sum(0)
    centroid_d = (dst * wn).sum(0)
    cov = ((src - centroid_s) * wn).t() @ (dst - centroid_d)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(vt.t() @ u.t())
    d_fix = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                    torch.sign(det)]))
    rot = vt.t() @ d_fix @ u.t()
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
        delta = -torch.linalg.solve(h, g)
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
    best_mask = inlier[torch.argmax(counts)]

    t_fit = rigid_transform(src, dst, best_mask.to(torch.float32) * weights)
    for _ in range(3):   # IRLS over the full match set, Huber at threshold
        w = _huber_weights(t_fit, src, dst, threshold) * validf * weights
        t_fit = rigid_transform(src, dst, w)
    w_fin = _huber_weights(t_fit, src, dst, threshold) * validf * weights
    comp = torch.tensor([1.0, 1.0, depth_rel_weight], dtype=torch.float32, device=dev)
    t_fit = refine_rigid_gn(t_fit, src, dst, w_fin, comp, rot_prior=rot_prior,
                            rot_prior_weight=rot_prior_weight)

    proj = se3.transform_points(t_fit, src)
    refined_mask = (torch.linalg.norm(proj - dst, dim=-1) < threshold) & valid
    count = refined_mask.sum()
    ok = count >= min_inliers
    t_out = torch.where(ok, t_fit, torch.eye(4, dtype=torch.float32, device=dev))
    return t_out, refined_mask, count, ok
