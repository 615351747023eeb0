"""Bundle-adjustment solver for one window problem (port of
apps/ba_solve.py): solve a problem from a file, or the synthetic self-test
(Gauss-Newton convergence and iterations per second).

  python -m online_3d_reconstruction_tpu_torch.apps.ba_solve --selftest [--window 8 --landmarks 256]
  python -m online_3d_reconstruction_tpu_torch.apps.ba_solve --problem problem.npz [--sharded N]

``--sharded N`` solves observation-sharded over a mesh of N ranks: 1, or the
size of the process group this process was started in (with ``torchrun``,
call ``runtime.distributed.initialize("env://")`` first).

problem.npz schema: poses (W,4,4), landmarks (L,3), lm_valid (L,),
obs_kf (N,), obs_lm (N,), obs_point (N,3), obs_valid (N,).
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import numpy as np

_PROBLEM_KEYS = ("poses", "landmarks", "lm_valid", "obs_kf", "obs_lm", "obs_point",
                 "obs_valid")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--problem", help="npz bundle problem (see schema above)")
    p.add_argument("--selftest", action="store_true",
                   help="synthetic bundle with known optimum")
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--landmarks", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--damping", type=float, default=1e-4)
    p.add_argument("--huber", type=float, default=0.5)
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="solve observation-sharded over a mesh of N ranks")
    p.add_argument("--output", help="write refined poses npz here")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default, no fallback) or cpu")
    args = p.parse_args(argv)
    import torch

    from online_3d_reconstruction_tpu_torch.ba.problem import problem_from_numpy
    from online_3d_reconstruction_tpu_torch.ba.schur import solve_ba
    from online_3d_reconstruction_tpu_torch.ba.testing import make_synthetic_bundle
    from online_3d_reconstruction_tpu_torch.geometry import se3
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device

    device = resolve_device(args.device)
    if args.selftest:
        problem, gt_poses, _ = make_synthetic_bundle(
            np.random.default_rng(0), w=args.window, l=args.landmarks,
            pose_noise=0.08, obs_noise=0.02, device=device)
    elif args.problem:
        with np.load(args.problem) as z:
            problem = problem_from_numpy(
                SimpleNamespace(**{k: z[k] for k in _PROBLEM_KEYS}), device)
        gt_poses = None
    else:
        raise SystemExit("need --problem or --selftest")

    kw = dict(iters=args.iters, damping=args.damping, huber_delta=args.huber)
    if args.sharded:
        from online_3d_reconstruction_tpu_torch.parallel import make_mesh, solve_ba_sharded

        mesh = make_mesh(args.sharded, device=device)

        def solve():
            return solve_ba_sharded(problem, mesh, **kw)
    else:
        def solve():
            return solve_ba(problem, **kw)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    solve()   # warm-up: first-call library and allocator start-up
    sync()
    t0 = time.perf_counter()
    poses, landmarks, trace = solve()
    sync()
    dt = time.perf_counter() - t0

    msg = {
        "device": str(device),
        "cost_trace": [float(c) for c in trace.cpu().numpy()],
        "gn_iters_per_s": args.iters / dt,
        "solve_ms": dt * 1e3,
    }
    if gt_poses is not None:
        gt = torch.as_tensor(np.asarray(gt_poses), dtype=torch.float32, device=device)
        t_err, _ = se3.geodesic_distance(gt, poses[:len(gt)])
        msg["mean_pose_error_m"] = float(t_err.mean())
    if args.output:
        np.savez(args.output, poses=poses.cpu().numpy(), landmarks=landmarks.cpu().numpy())
    print(json.dumps(msg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
