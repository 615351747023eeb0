"""The W=64 slot-major Schur solve, timed part by part (port of
tools/profile_ba64.py).

    python -m online_3d_reconstruction_tpu_torch.tools.profile_ba64
        [--w 64] [--l 2048] [--k 512] [--device cuda]

Splits one Gauss-Newton iteration of ``solve_ba`` on a synthetic bundle
(W keyframes, L landmarks, K observations a keyframe) into its parts, so
that the dominant term is a measurement:

- residuals and jacobians (the gathers by keyframe and landmark),
- the slot-major accumulation of the normal blocks,
- ``schur_solve`` and its parts (C^-1, E C^-1, the S product, the 6W x 6W
  Cholesky factor and solve),
- ``total_cost`` (a step evaluates the cost before and after it),

then ``solve_ba`` at 1 and 5 iterations and in the three forms the pipeline
runs it in (3x3 observation information with priors, either alone). Each
row is ``utils.roofline.measure_amortized``: on a card, device time by CUDA
events over back-to-back calls, the host's launches included. On a card a
``solve_ba`` row also shows the device launches of ONE call and the time
the device is busy in it, from ``torch.profiler``: a solve whose busy time
is far below its row is bound by the host's launches.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.ba.problem import (
    StereoNoiseModel,
    jacobians,
    residuals,
    stereo_obs_information,
    total_cost,
)
from online_3d_reconstruction_tpu_torch.ba.schur import (
    accumulate_normal_blocks,
    inv3x3,
    schur_solve,
    solve_ba,
)
from online_3d_reconstruction_tpu_torch.ba.testing import make_synthetic_bundle
from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
from online_3d_reconstruction_tpu_torch.utils.roofline import measure_amortized

# the rows of one Gauss-Newton step: two cost evaluations, the accumulation
# (residuals and jacobians inside it) and the reduced solve
STEP_PARTS = (("total_cost (one eval)", 2), ("accumulate slot-major (incl res+jac)", 1),
              ("schur_solve (inv+EC+S+chol+backsub)", 1))
ONE_STEP = "solve_ba 1 iter (2 cost evals + acc + solve)"


def device_launches(fn: Callable[[], object], device: torch.device) -> Tuple[int, float]:
    """(launches, busy ms) of one ``fn()`` on a CUDA ``device``: the kernels
    and copies ``torch.profiler`` records on the device, and their summed
    duration."""
    fn()
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_device:
        raise RuntimeError("torch.profiler recorded no device activity")
    return len(on_device), sum(e.time_range.elapsed_us() for e in on_device) * 1e-3


def main(argv=None) -> List[Tuple[str, float]]:
    """Prints one row per part and returns [(name, seconds), ...]."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--w", type=int, default=64)
    ap.add_argument("--l", type=int, default=2048)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w64, l64, k64 = args.w, args.l, args.k
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          f"W={w64} L={l64} K={k64}", flush=True)
    problem, _, _ = make_synthetic_bundle(
        np.random.default_rng(2), w=w64, l=l64, obs_noise=0.02,
        n_cap=w64 * k64, obs_per_kf=k64, device=dev)
    poses, lms = problem.poses, problem.landmarks
    huber = 0.5
    rows: List[Tuple[str, float]] = []

    def report(name, sec, solve=None):
        rows.append((name, sec))
        line = f"{name:44s} {sec * 1e3:8.3f} ms"
        if solve is not None and dev.type == "cuda":
            launches, busy_ms = device_launches(solve, dev)
            line += f"  {launches:5d} launches, device busy {busy_ms:7.3f} ms"
        print(line, flush=True)

    def bench(name, fn, args_, inner):
        report(name, measure_amortized(fn, args_, inner=inner))

    bench("residuals (one pass)", lambda p: residuals(poses, lms, p), (problem,), 16)
    bench("jacobians (one pass)", lambda p: jacobians(poses, lms, p), (problem,), 16)
    bench("total_cost (one eval)", lambda p: total_cost(poses, lms, p, huber),
          (problem,), 16)
    bench("accumulate slot-major (incl res+jac)",
          lambda p: accumulate_normal_blocks(poses, lms, p, huber, slot_major=k64),
          (problem,), 8)
    blocks = accumulate_normal_blocks(poses, lms, problem, huber, slot_major=k64)
    bench("schur_solve (inv+EC+S+chol+backsub)",
          lambda *b: schur_solve(*b, 1e-4, True), tuple(blocks), 8)

    _, c, e, gp, _ = blocks
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    bench(f"  C^-1 ({l64} adjugate 3x3 inv)", lambda cc: inv3x3(cc + 1e-4 * eye3), (c,), 16)
    c_inv = inv3x3(c + 1e-4 * eye3)
    bench("  EC^-1 einsum", lambda ee: torch.einsum("wlij,ljk->wlik", ee, c_inv), (e,), 8)
    ec = torch.einsum("wlij,ljk->wlik", e, c_inv)
    bench("  S coupling einsum (W^2 L 6 6 3)",
          lambda ee: torch.einsum("aljk,blmk->ajbm", ec, ee), (e,), 8)
    n = w64 * 6
    s_full = torch.eye(n, dtype=torch.float32, device=dev) * 100.0
    bench(f"  cho_factor {n}x{n}", lambda s: torch.linalg.cholesky_ex(s)[0], (s_full,), 16)
    chol = torch.linalg.cholesky_ex(s_full)[0]
    bench(f"  cho_solve {n}", lambda r: torch.cholesky_solve(r, chol),
          (gp.reshape(n, 1),), 16)

    def solve_row(name, p, inner, **kw):
        def solve(q=p):
            return solve_ba(q, damping=1e-4, slot_major=k64, **kw)

        report(name, measure_amortized(solve, (p,), inner=inner), solve=solve)

    solve_row(ONE_STEP, problem, 8, iters=1, huber_delta=huber)
    solve_row("solve_ba 5 iters (the bench kernel)", problem, 4, iters=5, huber_delta=huber)

    # the pipeline's own solve: the full 3x3 observation information and the
    # priors, then each of the two alone
    nm = StereoNoiseModel(fx=400.0, fy=400.0, baseline=0.5, sigma_px=0.5,
                          sigma_disparity=1.0)
    info = stereo_obs_information(problem.obs_point, nm)
    with_priors = dict(priors=problem.poses,
                       prior_valid=torch.ones(w64, dtype=torch.bool, device=dev))
    prior_weights = dict(anchor_first=False, prior_position_weight=44.4,
                         prior_rotation_weight=1e4)
    solve_row("solve_ba 5 it (3x3 info + priors, in-situ)",
              problem._replace(obs_weight=info, **with_priors), 4, iters=5,
              huber_delta=3.0, **prior_weights)
    solve_row("solve_ba 5 it (3x3 info only)", problem._replace(obs_weight=info), 4,
              iters=5, huber_delta=3.0)
    solve_row("solve_ba 5 it (priors only)", problem._replace(**with_priors), 4,
              iters=5, huber_delta=huber, **prior_weights)
    return rows


if __name__ == "__main__":
    main()
