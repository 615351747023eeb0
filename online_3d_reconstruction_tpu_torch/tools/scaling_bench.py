"""Work split and communicated bytes of the sharded stages at n = 1, 2, 4,
8 ranks (port of tools/scaling_bench.py), and their wall-clock on CPU ranks.

    python -m online_3d_reconstruction_tpu_torch.tools.scaling_bench [--small] [--wall 1 2 4]

The tables are analytic, from the programs' shapes, and do not depend on
the interconnect: what each rank computes, and the bytes each collective
carries. ``--wall`` also times each stage on that many CPU processes over
gloo on THIS machine's cores (``parallel.launch.run_ranks``): that shows
that the sharded programs split the WORK and agree with each other; it is
no GPU time and says nothing of NVLink or of scaling on cards, and every
such number is labelled ``cpu_gloo``. ``--small`` takes small shapes.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

NS = (1, 2, 4, 8)
CENSUS_RADIUS = 2       # the default 5x5 census window

# the reference tool's shapes, and small ones for a quick run
FULL = dict(
    ba=dict(w=64, l=512, n_obs=8192, iters=5),
    slots=dict(w=64, l=2048, k=512, iters=5),
    voxel=dict(n=8_000_000, bounds=512.0, voxel_size=1.0),
    sgm=dict(h=768, w=1024, d=64, paths=4, halo=32))
SMALL = dict(
    ba=dict(w=8, l=64, n_obs=512, iters=3),
    slots=dict(w=8, l=64, k=32, iters=3),
    voxel=dict(n=65_536, bounds=64.0, voxel_size=1.0),
    sgm=dict(h=96, w=128, d=16, paths=4, halo=8))


def _bucket_capacity(n_points: int, n: int) -> int:
    """1.5x the balanced-hash expectation of records per (source, owner)."""
    n_local = n_points // n
    return min(n_local, -(-3 * n_local // (2 * n)))


def analytic(shapes: dict) -> list:
    """Per stage: the collective, its bytes per call and calls per solve or
    frame, and the work of one rank at each n."""
    ba, sl, vx, sg = shapes["ba"], shapes["slots"], shapes["voxel"], shapes["sgm"]
    blocks = 4 * (ba["w"] * 36 + ba["l"] * 9 + ba["w"] * ba["l"] * 18
                  + ba["w"] * 6 + ba["l"] * 3)
    gather = 4 * (sl["w"] * (36 + 6) + sl["w"] * sl["l"] * 18)
    reduce_ = 4 * (sl["l"] * 9 + sl["l"] * 3)
    pad = sg["halo"] + CENSUS_RADIUS
    return [
        dict(name=f"P2 BA W={ba['w']} L={ba['l']} obs={ba['n_obs']} it={ba['iters']}",
             collective="all_reduce(B,C,E,g_p,g_x as one buffer)",
             bytes_per_call=blocks, calls=ba["iters"],
             work_per_rank={n: dict(observations=-(-ba["n_obs"] // n)) for n in NS},
             note="a ring all-reduce moves 2(n-1)/n x bytes per rank"),
        dict(name=f"P2 slot-sharded BA W={sl['w']} L={sl['l']} "
                  f"obs={sl['w'] * sl['k']} it={sl['iters']}",
             collective="all_reduce(C,g_x) + all_gather(B,g_p,E)",
             bytes_per_call=gather + reduce_, calls=sl["iters"],
             work_per_rank={n: dict(slots=sl["w"] // n, observations=sl["w"] // n * sl["k"])
                            for n in NS if sl["w"] % n == 0},
             note="the gather's bytes are dominated by the (W,L,6,3) E blocks"),
        dict(name=f"P3 owner-routed voxel merge {vx['n']} pts",
             collective="all_to_all(packed voxel records) + all_reduce(dropped)",
             bytes_per_call=vx["n"] * (7 * 4 + 8), calls=1,
             work_per_rank={n: dict(points_sorted=vx["n"] // n,
                                    records_merged=n * _bucket_capacity(vx["n"], n))
                            for n in NS},
             note="upper bound: each locally unique voxel record (28 B of sums + an "
                  "8 B key) crosses the wire at most once"),
        dict(name=f"P4 row-slab SGM {sg['w']}x{sg['h']} D={sg['d']} halo={sg['halo']}",
             collective="2 shifts per image (halo rows, both images)",
             bytes_per_call=2 * 2 * pad * sg["w"] * 4, calls=1,
             work_per_rank={n: dict(rows_aggregated=sg["h"] // n + 2 * sg["halo"],
                                    redundancy=(sg["h"] // n + 2 * sg["halo"]) * n / sg["h"])
                            for n in NS if sg["h"] % n == 0 and sg["h"] // n > sg["halo"]},
             note="halo rows of the raw images; the cost volume stays local"),
    ]


def _timeit(fn, barrier, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        barrier()
        t0 = time.perf_counter()
        fn()
        barrier()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def rank_job(mesh, workdir):
    """One CPU rank of the wall-clock run: every stage on seeded data, timed
    between barriers; also a digest of each result, for the caller to hold
    the rank counts against each other."""
    import torch
    import torch.distributed as dist

    from online_3d_reconstruction_tpu_torch.ba.testing import make_synthetic_bundle
    from online_3d_reconstruction_tpu_torch.config import StereoConfig
    from online_3d_reconstruction_tpu_torch.parallel.ba_sharded import (
        solve_ba_sharded, solve_ba_slot_sharded)
    from online_3d_reconstruction_tpu_torch.parallel.sgm_sharded import sharded_disparity
    from online_3d_reconstruction_tpu_torch.parallel.voxel_sharded import voxel_route_merge

    shapes = json.loads((Path(workdir) / "shapes.json").read_text())
    ba, sl, vx, sg = shapes["ba"], shapes["slots"], shapes["voxel"], shapes["sgm"]
    n = mesh.size

    def barrier():
        if mesh.group is not None:
            dist.barrier(group=mesh.group)

    out = {}
    problem, _, _ = make_synthetic_bundle(np.random.default_rng(0), w=ba["w"], l=ba["l"],
                                          obs_noise=0.02, n_cap=ba["n_obs"], device="cpu")
    solve = lambda: solve_ba_sharded(problem, mesh, iters=ba["iters"])   # noqa: E731
    out["ba_s"], out["ba_digest"] = _timeit(solve, barrier), solve()[2].numpy()

    if sl["w"] % n == 0:
        problem, _, _ = make_synthetic_bundle(
            np.random.default_rng(3), w=sl["w"], l=sl["l"], obs_noise=0.02,
            n_cap=sl["w"] * sl["k"], obs_per_kf=sl["k"], device="cpu")
        solve = lambda: solve_ba_slot_sharded(   # noqa: E731
            problem, mesh, slot_major=sl["k"], iters=sl["iters"])
        out["slots_s"], out["slots_digest"] = _timeit(solve, barrier), solve()[2].numpy()

    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-vx["bounds"], vx["bounds"],
                                       (vx["n"], 3)).astype(np.float32))
    cols = torch.from_numpy(rng.random((vx["n"], 3), dtype=np.float32))
    ok = torch.ones(vx["n"], dtype=torch.bool)
    merge = lambda: voxel_route_merge(   # noqa: E731
        pts, cols, ok, mesh, vx["voxel_size"], vx["bounds"],
        bucket_capacity=_bucket_capacity(vx["n"], n))
    out["voxel_s"] = _timeit(merge, barrier, reps=2)
    cloud, dropped = merge()
    out["voxel_digest"] = np.array([int(cloud.valid.sum()), int(dropped)])

    if sg["h"] % n == 0 and sg["h"] // n > sg["halo"]:
        cfg = StereoConfig(height=sg["h"], width=sg["w"], max_disparity=sg["d"],
                           num_paths=sg["paths"], speckle_window=0)
        rng = np.random.default_rng(2)
        left = torch.from_numpy(rng.random((sg["h"], sg["w"]), dtype=np.float32))
        right = torch.from_numpy(rng.random((sg["h"], sg["w"]), dtype=np.float32))
        run = lambda: sharded_disparity(left, right, cfg, mesh, halo=sg["halo"])  # noqa: E731
        out["sgm_s"] = _timeit(run, barrier, reps=2)
        out["sgm_digest"] = np.array([float(run()[1].float().mean())])
    return {k: np.asarray(v) for k, v in out.items()}


def wall_clock(shapes: dict, ranks, timeout: float = 900.0) -> dict:
    """{stage: {n: seconds}} on CPU gloo ranks, and {stage: {n: digest}}."""
    from online_3d_reconstruction_tpu_torch.parallel.launch import run_ranks

    seconds, digests = {}, {}
    for n in ranks:
        with tempfile.TemporaryDirectory(prefix="o3r_scaling_") as workdir:
            (Path(workdir) / "shapes.json").write_text(json.dumps(shapes))
            results = run_ranks(f"{__spec__.name}:rank_job", n, workdir, timeout=timeout)
        for key, value in results[0].items():
            stage, kind = key.rsplit("_", 1)
            if kind == "s":
                # the ranks leave a stage together: the slowest one's time
                seconds.setdefault(stage, {})[n] = max(float(r[key]) for r in results)
            else:
                digests.setdefault(stage, {})[n] = value.tolist()
    return dict(seconds=seconds, digests=digests)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--small", action="store_true", help="small shapes (a quick run)")
    p.add_argument("--wall", type=int, nargs="*", default=[], metavar="N",
                   help="also time every stage on N CPU processes over gloo")
    p.add_argument("--output", help="write the result as JSON here")
    args = p.parse_args(argv)
    shapes = SMALL if args.small else FULL
    result = dict(stages=analytic(shapes))
    print("\n## Communicated bytes per collective and work per rank "
          "(analytic, from shapes)\n")
    print("| stage | collective | bytes/call | calls | work of one rank at n = "
          + ", ".join(map(str, NS)) + " |")
    print("|---|---|---|---|---|")
    for row in result["stages"]:
        work = "; ".join(f"n={n}: " + ", ".join(f"{k} {v:g}" for k, v in w.items())
                         for n, w in row["work_per_rank"].items())
        print(f"| {row['name']} | {row['collective']} | "
              f"{row['bytes_per_call'] / 1e6:.3f} MB | {row['calls']} | {work} |")
    if args.wall:
        result["cpu_gloo"] = wall_clock(shapes, args.wall)
        print("\n## Wall-clock on CPU processes over gloo, one machine's cores "
              "(cpu_gloo: not a GPU time, no statement about scaling on cards)\n")
        print("| stage | " + " | ".join(f"n={n}" for n in args.wall) + " |")
        print("|---|" + "---|" * len(args.wall))
        for stage, row in result["cpu_gloo"]["seconds"].items():
            print(f"| {stage} | " + " | ".join(
                f"{row[n] * 1e3:.0f} ms" if n in row else "-" for n in args.wall) + " |")
    if args.output:
        Path(args.output).write_text(json.dumps(result, indent=2))
        print(f"\nwritten: {args.output}")
    return result


if __name__ == "__main__":
    main()
