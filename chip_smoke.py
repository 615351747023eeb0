"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of findings:
  1. device: a CUDA card must exist (else exit non-zero, no result), TF32
     must be off; prints the card's name and power limit from nvidia-smi;
  2. build: compiles the CUDA kernels from csrc/ with nvcc (one process per
     source, in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes and at ragged ones (bit-equal), with CUDA-event times
     of both beside the kernel's bound (its compulsory bytes at the card's
     memory rate, or its operations at the card's f32 rate, whichever is
     larger); K1 in its f32 form and its half form (the reference's four
     roundings) in bf16 and fp16, at 8, 4 and 2 paths, their times side by
     side with the launches of one aggregation; the half form at the
     largest P2 its 32-bit words take and one past it (the ordered form),
     with fractional penalties twice (equal between the runs; the half
     forms bit-equal to the plain version, f32 within 1e-3 relative); K3
     as each pass alone and as the one-launch pair, also on a skewed volume
     with 1e9 padding cells and as a diagonal round trip; K4 (census and
     cost volume) bit-equal to its plain chain at 384x512x64, 480x752x64
     and 384x512x128 and at ragged shapes and windows, its time alone
     (launches replayed from a CUDA graph) beside its compulsory bytes and
     the plain chain's time; K5 (the map's voxel reduction) on the 2M main
     pool at the EuRoC and the survey cells' grids and on their staging
     pools, bit-equal to the plain reduction run on a CPU copy given the
     keys PyTorch computes on the card (and to the whole plain form where
     1 / voxel size is exact), one reduction counted a call, its time from
     a CUDA graph and eager, the stable sort's and the cumsum's alone, and
     the plain form's (``index_add_``) beside the compulsory bytes; K6
     (tracking's RANSAC draw) bit-equal to its plain chain on the card and
     on the CPU for seeds, frame indices, n and hypotheses a frame, its time
     alone and the plain chain's, both replayed from a CUDA graph;
  4. main path: ``reconstruct(..., device="cuda")`` on the benchmark scene
     and its full-stack configuration (512x384, D=64, 8-path SGM, distorted
     rig, window BA W=24/L=2048/3 GN iterations with the stereo noise model),
     32 frames, at the default bf16 aggregation and again at
     ``cost_dtype="float32"``; kernel launch counts from each run (K4 1, K1 2
     and K2 4 per frame, K1's launches the bf16 form's in the first run and
     none of them in the second, K5 at least finish's flush and downsample,
     K6 and K7 1 each per tracked frame), ATE against ground truth beside
     prior-only ATE (full stack must reach <= 0.5x; the kernels are
     bit-equal or, K7, sum in a fixed order, so each run repeats its digits:
     0.11037891 m and 408,276 map points in f32, 0.11038489 m and 408,280 in
     bf16),
     the BA-off VO-only ablation, the library's default configuration on
     the first 12 frames, disparity quality on one frame; then the step
     graph: the default run's steady frames are replays of captured CUDA
     graphs (at most one capture per variant, every other steady frame a
     replay, K1/K2 counted through the replays), held against the same
     frames through the eager step (trajectory within 1e-4 m and 1e-4 rad,
     map size within 0.5%, both ATEs <= 0.5x prior-only); then K7 (tracking's
     IRLS fit) against its plain form on the card and on the CPU, to float32
     rounding, on the second frame's real matches (N = 512) and on random
     ones at N = 517 and 2000, the identity for zero weights, its time alone
     and the plain chain's, both replayed from a CUDA graph;
  5. bench: the port's bench (``bench.main``, the port of bench.py) on the
     main path's 32 frames: one stdout line with the reference's four keys
     and a value > 0; the streamed run's full-stack ATE must repeat the main
     path's and stay <= 0.5x prior-only, its VO-only ATE must equal the
     ablation's above and its map size the main path's (0.5%); K1 2 and K2
     4 launches a frame in each of its three runs; its five kernel rows
     resolved (no "invalid"), its K1 row (bf16) within 2x of the kernel
     phase's;
  6. steady-frame and stage-part profilers: ``tools.profile_steady.main``
     on the bench setup warmed on 12 frames and ``tools.profile_stage_parts
     .main`` at 384x512x64, every row of their reference tools, with the K1
     and K2 launches of each;
  7. apps: the user's entry points on a disk folder of the same 32 frames
     (RGB left and gray right .npy named by timestamp, a quaternion flight-log
     CSV of the priors, the rig's calibration JSON, the configuration as a
     JSON): ``apps.reconstruct.main`` straight through (priors read back
     within 1e-5, ATE <= 0.5x prior-only, K1/K2 launched 2 and 4 times per
     frame, map.ply and trajectory.tum read back), cut at half and resumed
     from its checkpoint (trajectory within 1e-4 m and 1e-4 rad of the
     uninterrupted one, map size within 0.5%), offline on the exact
     disparity (no K1/K2 launch), with a 3-level pyramid, with the profiler
     (a trace file); ``apps.depth`` on frame 12 (density > 0.9, bad>1px <
     0.02) and ``apps.ba_solve --selftest`` (the cost falls); the host syncs
     of one steady keyframe frame without the prefetcher, and with it none
     (upload and graph step under the sync debug mode "error"), the host's
     CUDA runtime calls in one steady frame (one graph launch), and a
     snapshot's size and write time at the 2M-point pool, after all 32
     frames and filled to capacity;
  8. profilers: ``tools.profile_stages.main`` at 384x512x64, every row of
     the reference tool and the port's bf16 aggregation row, its scan-pair
     row one K3 launch a call; then
     ``tools.profile_sgm.main`` at the same size, the vertical, horizontal
     and skewed-diagonal scan pairs and each K3 pass alone in f32 and bf16,
     with K3's launch counts from these runs;
  9. agreement of the CUDA and CPU runs on a small input, BA off and on;
 10. distributed: a process group of ONE rank on the card (nccl, a file
     store), every collective of ``parallel.mesh`` through it, K1 bit-equal
     in all three storages at the row-slab shapes 448x512x64 and 160x512x64,
     ``sharded_disparity`` on a bench frame against ``sgm_disparity``
     (within 1 px on > 0.995 of the pixels both call valid),
     ``reconstruct_distributed`` over the 32 frames (K1 2 and K2 4 launches
     a frame, the single run's keyframes, ATE <= 0.5x prior-only), the two
     sharded solves at W=64 / L=2048 / 512 a slot and both sharded voxel
     forms on a full staging pool against their single-device forms, and
     ``tools.scaling_bench`` on 1 and 4 CPU processes over gloo (small
     shapes; the rank counts must agree);
 11. lab: the estimator and solver lab on the lab scene (384x512, D=64,
     IDENTITY rig, so the frame path skips rectification; 32 frames rendered
     once with supersample 2 and once without): ``tools.sgm_cache`` on 32
     frames (its bf16 aggregation; K1 64 and K2 128 launches; frame 0 equal
     to ``sgm_disparity`` with the plain versions forced on the card),
     ``tools.bias_vs_edge`` on
     its NPZ, ``tools.ate_lab`` with two variants offline and on the cache
     (no launch) and with ``--sgm`` (the exact f32 aggregation, as the
     reference tool; K1 2 and K2 4 a frame, ATE <= 0.5x prior-only),
     ``tools.vo_link_err``, ``tools.ba_bias``, ``tools.ate_diag`` (tables
     parsed, finite), and the solver profilers
     ``tools.profile_match``, ``tools.profile_ba64`` (its parts within a
     factor 3 of its one-iteration solve) and ``tools.ba_scale`` at W = 8,
     24, 64, 100.
Then one JSON line with the kernels (times from the kernel phase, launches
from the main path's runs, K3's from the profilers'), and as the last line
{"ok": true, "device": {...}}. Any failure raises: exit code non-zero.
Kernel launches are read from ``cuda_build.launch_counts``. Frame rates and
stage times are not measured here: the benchmark (``o3r_bench``) and the
program's own trace (``python3 -m o3r_bench.program_trace ... --profile 1``)
give them. Uses only the port (no JAX).
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import multiprocessing
import re
import subprocess
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "online_3d_reconstruction_tpu_torch"

N_WARMUP, N_TIMED = 12, 20       # the benchmark's split of its 32 frames
PRIOR_T_SIGMA, PRIOR_R_SIGMA = 0.15, 0.01
# the reference's quality numbers on this scene and configuration
# (BENCH_DETAIL.json "ate_m"; they are not times)
REF_ATE_FULL, REF_ATE_VO = 0.11038447636199869, 0.3981888038487815
REF_ATE_PRIOR = 0.23559162924213733
# the port's own full-stack ATE and map size on this scene, per storage of
# the aggregation: the same digits in every run (K1-K6 are bit-equal to
# their plain versions, K7 sums in a fixed order, and the trajectory does not
# depend on the map's atomics); the bf16 run's ATE is the reference's to
# 5e-7 m. K7's sums moved them from bf16 0.11038463 m / 408,281 and f32
# 0.11038505 m / 408,275 (the plain fit's digits), as its poses differ from
# the plain fit's by ~1e-7 relative
PORT_RUNS = {"float32": (0.11037891, 408_276), "bfloat16": (0.11038489, 408_280)}
# the CLI's offline run on the exact disparity: every point lies on the
# ground plane or the plateau top (8 m), one to two layers of 0.25 m voxels,
# where SGM's depth noise (~1 m at 30 m) spreads a surface over many
PORT_OFFLINE_MAP_POINTS, PLATEAU_HEIGHT = 55_953, 8.0
# kernel launches of one steady frame with the default (integer) penalties:
# K4 = the census of both images and the cost volume;
# K1 = the all-directions aggregation + the widening of its 16-bit sums (f32)
# or the last two roundings of its 32-bit words (the half form, bf16)
LAUNCHES_PER_FRAME = {"census_cost": 1, "sgm_path": 2, "run_total": 4}
# kernel launches of each tracked frame (every frame but the first): K6 = the
# RANSAC draw, K7 = the refit on the best hypothesis' inliers and its IRLS steps
TRACKING_LAUNCHES_PER_FRAME = {"ransac_draw": 1, "rigid_irls": 1}
# NVIDIA H100 SXM (data sheet): HBM3 bytes/s and f32 operations/s outside the
# tensor cores; a kernel's bound is the larger of bytes and operations over these
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def stereo_launches(counts: dict) -> dict:
    """The SGM stage's kernels' launches in ``counts`` (all but K5's, which
    runs wherever the map is downsampled, and tracking's K6 and K7)."""
    return {name: n for name, n in counts.items()
            if name not in ("voxel_reduce", *TRACKING_LAUNCHES_PER_FRAME)}


# ---------------------------------------------------------------------------
# scene and configuration (the benchmark's)
# ---------------------------------------------------------------------------

def make_sequence(h: int, w: int, fx: float, n_frames: int, altitude: float,
                  speed: float):
    from online_3d_reconstruction_tpu_torch.io import (
        CameraIntrinsics, Plateau, StereoCalibration, SyntheticScene,
        SyntheticSequence, make_survey_trajectory, stereo_rectify)

    cam = CameraIntrinsics(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h,
                           dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
    calib = StereoCalibration(left=cam, right=cam,
                              translation=np.array([-0.5, 0.0, 0.0]))
    rig = stereo_rectify(calib)
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                           supersample=2)
    poses = make_survey_trajectory(n_frames, altitude=altitude, speed=speed)
    data = SyntheticSequence(scene=scene, rig=rig, poses=poses,
                             prior_translation_sigma=PRIOR_T_SIGMA,
                             prior_rotation_sigma=PRIOR_R_SIGMA, calib=calib)
    return rig, data


def _render(args):
    data, i = args
    return data[i]


def render_frames(data) -> list:
    """Render every frame on the host, in parallel worker processes."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=8, mp_context=ctx) as pool:
        return list(pool.map(_render, [(data, i) for i in range(len(data))]))


def make_config(h: int, w: int, d: int, max_keypoints: int, capacity: int,
                ba: bool, cost_dtype: str = "bfloat16"):
    """The benchmark's configuration: with ``ba`` its full stack (window BA
    with the measured estimator preset), else its VO-only ablation. The SGM
    aggregation is stored in ``cost_dtype`` (the default, bfloat16, as the
    reference runs on its own chip; float32 is exact)."""
    from online_3d_reconstruction_tpu_torch.config import (
        BAConfig, FeatureConfig, MappingConfig, OdometryConfig, PipelineConfig,
        RuntimeConfig, StereoConfig)

    return PipelineConfig(
        stereo=StereoConfig(height=h, width=w, max_disparity=d, num_paths=8,
                            use_pallas=True, cost_dtype=cost_dtype),
        features=FeatureConfig(max_keypoints=max_keypoints, fast_threshold=5.0),
        odometry=OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        ba=BAConfig(obs_weighting=True, sigma_pixel=0.5, sigma_disparity=1.0,
                    huber_delta=3.0, window=24, max_landmarks=2048, gn_iters=3,
                    prior_position_weight=1.0 / PRIOR_T_SIGMA**2,
                    prior_rotation_weight=1.0 / PRIOR_R_SIGMA**2),
        mapping=MappingConfig(voxel_size=0.25, map_capacity=capacity,
                              frame_point_stride=2, color_stride=4,
                              min_depth=1.0, max_depth=60.0),
        runtime=RuntimeConfig(keyframe_translation=0.5, sync_metrics=False,
                              ba_every_keyframe=ba),
    )


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def rotation_angle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle (rad) between the rotations of pose stacks a and b (N, 4, 4):
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), well conditioned near 0."""
    diff = a[:, :3, :3].astype(np.float64) - b[:, :3, :3].astype(np.float64)
    return 2.0 * np.arcsin(np.clip(np.linalg.norm(diff, axis=(1, 2))
                                   / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def bound(tensors, operations: float) -> dict:
    """The least time the card could take: ``tensors`` (each input read
    once, each output written once) at the memory rate, or ``operations``
    at the f32 rate, whichever is larger."""
    by_bytes = 1e3 * sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    by_ops = 1e3 * operations / F32_OPS_PER_S
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device milliseconds of one ``fn()``: ``calls`` calls captured in one
    CUDA graph and replayed, timed by events, so that no host launch gap
    stands between two kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, replays) / calls


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` runs, by events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    if not PACKAGE.is_dir():
        raise SystemExit(f"{PACKAGE.name}/ not found beside {Path(__file__).name}: "
                         "run from the root of a checkout")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this smoke run "
                         "needs an NVIDIA card")
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device

    device = resolve_device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return device


def phase_build():
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    cuda_build.load_kernels()
    log("build", library=str(cuda_build.library_path().relative_to(ROOT)),
        build_s=cuda_build.build_seconds)


def _speckle_inputs(device):
    """A 384x512 disparity field with speckles, the four run-total calls'
    inputs of its speckle filter."""
    import torch

    from online_3d_reconstruction_tpu_torch.stereo.sgm import _shift_down

    gen = torch.Generator().manual_seed(3)
    h, w = 384, 512
    disp = torch.round(torch.rand((h, w), generator=gen) * 60 / 8) * 8
    disp = disp + 0.2 * torch.randn((h, w), generator=gen)
    valid = torch.rand((h, w), generator=gen) > 0.2
    disp, valid = disp.to(device), valid.to(device)
    val = valid.to(torch.float32)

    def start(axis):
        conn = (val * _shift_down(val, axis)
                * ((disp - _shift_down(disp, axis)).abs() <= 1.0).to(torch.float32))
        return 1.0 - conn

    return disp, valid, val, start(0), start(1)


def phase_kernels(device):
    import torch

    from online_3d_reconstruction_tpu_torch.stereo import sgm, sgm_cuda
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    rows, bytes_ms, forms = [], {}, {}
    gen = torch.Generator().manual_seed(0)
    cost = torch.randint(0, 33, (384, 512, 64), generator=gen,
                         dtype=torch.uint8).to(device)
    source = "online_3d_reconstruction_tpu_torch/csrc/sgm_aggregate.cu"
    multi = "online_3d_reconstruction_tpu/stereo/sgm_pallas.py:224"

    def launches_of(fn):
        cuda_build.reset_launch_counts()
        fn()
        return cuda_build.launch_counts["sgm_path"]

    # K1's forms at the main path's shape: f32 (o3r_sgm_aggregate packed +
    # o3r_sgm_unpack16) and the half form (o3r_sgm_aggregate_half +
    # o3r_sgm_finish_half; one launch at 2 paths) in bf16, the main path's,
    # and in fp16; each at 8, 4 and 2 paths, bit-equal to its plain version
    for dtype, name, entries in (
            (torch.float32, "sgm_path_aggregation", ["o3r_sgm_aggregate", "o3r_sgm_unpack16"]),
            (torch.bfloat16, "sgm_path_aggregation_half",
             ["o3r_sgm_aggregate_half", "o3r_sgm_finish_half"]),
            (torch.float16, None, None)):
        for paths in (8, 4, 2):
            got = sgm_cuda.aggregate(cost, 8.0, 32.0, paths, dtype)
            want = sgm_cuda.aggregate_plain(cost, 8.0, 32.0, paths, dtype)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not (got.dtype == dtype and torch.equal(got, want)):
                raise AssertionError(f"K1 {dtype} ({paths} paths) differs from its plain "
                                     f"version: max abs err {err}")
            forms[str(dtype), paths] = dict(
                ms=cuda_ms(lambda: sgm_cuda.aggregate(cost, 8.0, 32.0, paths, dtype), 50),
                launches=launches_of(lambda: sgm_cuda.aggregate(cost, 8.0, 32.0, paths, dtype)))
            if paths == 8 and name is not None:
                plain_ms = cuda_ms(
                    lambda: sgm_cuda.aggregate_plain(cost, 8.0, 32.0, 8, dtype), 2, warmup=0)
                # per cell and direction: 4 fminf, 4 additions, and its share
                # of the min over D (2); bytes: the uint8 cost in, the total out
                row = dict(name=name, route="cuda", source=source, replaces=multi,
                           entry_points=entries, dtype=str(dtype).replace("torch.", ""),
                           max_abs_err=err, ms=forms[str(dtype), 8]["ms"], plain_ms=plain_ms,
                           **bound([cost, got], 10.0 * paths * cost.numel()),
                           library_ms=None)
                rows.append(row)
                # the compulsory bytes alone (the cost in, the total out)
                bytes_ms[name] = bound([cost, got], 0.0)["bound_ms"]
            log("kernel K1", dtype=str(dtype), paths=paths, shape=[384, 512, 64],
                equal=True, max_abs_err=err, **forms[str(dtype), paths])
    k1, k1_half = rows
    half_bytes_ms = bytes_ms[k1_half["name"]]
    log("kernel K1 forms", shape=[384, 512, 64], note="one aggregation, CUDA events, "
        "this call; bytes bound: the uint8 cost in, the total out, at 3.35 TB/s",
        bf16_ms=forms["torch.bfloat16", 8]["ms"],
        f32_ms=forms["torch.float32", 8]["ms"], fp16_ms=forms["torch.float16", 8]["ms"],
        bf16_bytes_bound_ms=half_bytes_ms,
        bf16_share_of_bytes_bound=half_bytes_ms / forms["torch.bfloat16", 8]["ms"],
        f32_bytes_bound_ms=bytes_ms[k1["name"]],
        f32_share_of_bytes_bound=bytes_ms[k1["name"]] / forms["torch.float32", 8]["ms"],
        bf16_bound_ms=k1_half["bound_ms"], bf16_bound_by=k1_half["bound_by"],
        bf16_share_of_bound=k1_half["bound_ms"] / k1_half["ms"],
        f32_bound_ms=k1["bound_ms"], f32_bound_by=k1["bound_by"],
        f32_share_of_bound=k1["bound_ms"] / k1["ms"],
        **{f"{dt.replace('torch.', '')}_paths{paths}_{key}": value
           for (dt, paths), form in forms.items() for key, value in form.items()})
    # ragged shapes: D not a multiple of 32 (padding lanes), D = 128 and 256
    # (4 and 8 per lane over the whole warp), D = 8 (16 lines a warp), H and
    # W not multiples of the block, diagonals longer than wide, odd widths
    # (the row pairs' middle cell); costs up to 160 so that bf16 rounds at
    # every path count
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    shapes = ((37, 45, 40), (33, 70, 128), (70, 33, 8), (21, 19, 256))
    for shape in shapes:
        small = torch.randint(0, 161, shape, generator=gen, dtype=torch.uint8).to(device)
        for dtype in dtypes:
            for paths in (8, 4, 2):
                if not torch.equal(sgm_cuda.aggregate(small, 8.0, 32.0, paths, dtype),
                                   sgm_cuda.aggregate_plain(small, 8.0, 32.0, paths, dtype)):
                    raise AssertionError(f"K1 {dtype} ({paths} paths) differs from its "
                                         f"plain version at {shape}")
    log("kernel K1", dtypes=[str(d) for d in dtypes], paths=[8, 4, 2],
        shapes=[list(s) for s in shapes], equal=True)
    # the half form at the largest integer P2 it takes (its 16-bit group
    # sums and stash: 21590 with 8 paths, 65280 with 4 and 2), with costs up
    # to 255 and, at P1 = P2, on a volume whose path values grow by 255 a
    # step up to 255 + P2 (8 paths: every sum at its largest in the middle,
    # the fp16 totals inf, as the plain version's), and one past it, which
    # takes the ordered form: bit-equal on both sides
    bounds = {8: 21590, 4: 65280, 2: 65280}
    wide = torch.randint(0, 256, (96, 128, 64), generator=gen, dtype=torch.uint8).to(device)
    full = torch.full((264, 264, 8), 255, dtype=torch.uint8, device=device)
    full[..., 0] = 0
    checked = []
    for dtype in (torch.bfloat16, torch.float16):
        for paths, p2 in bounds.items():
            for p1, penalty, fits in ((8.0, p2, True), (float(p2), p2, True),
                                      (8.0, p2 + 1, False)):
                if sgm_cuda.groups_fit_32_bits(p1, float(penalty), paths) != fits:
                    raise AssertionError(f"groups_fit_32_bits({p1}, {penalty}, {paths}) "
                                         f"is not {fits}")
                for volume in (wide, full):
                    n = launches_of(lambda: sgm_cuda.aggregate(volume, p1, float(penalty),
                                                               paths, dtype))
                    want_n = ((1 if paths == 2 else 2) if fits
                              else paths + (2 if paths == 2 else 4))
                    want = sgm_cuda.aggregate_plain(volume, p1, float(penalty), paths, dtype)
                    if not (n == want_n and torch.equal(
                            sgm_cuda.aggregate(volume, p1, float(penalty), paths, dtype), want)):
                        raise AssertionError(f"K1 {dtype} ({paths} paths) at P1 {p1}, P2 "
                                             f"{penalty} on {tuple(volume.shape)}: {n} "
                                             f"launches, or differs from its plain version")
                checked.append([str(dtype), paths, p1, penalty, "packed" if fits else "ordered"])
    exact = sgm_cuda.aggregate_plain(full, 21590.0, 21590.0, 8)
    log("kernel K1 half form at its bound", shapes=[list(wide.shape), list(full.shape)],
        cases=checked, equal=True, full_8_path_exact_max=float(exact.max()))
    if float(exact.max()) != 8 * (255 + 21590):
        raise AssertionError(f"the full volume's 8-path sums reach {float(exact.max())}, "
                             f"not 8 x (255 + 21590)")
    # penalties that are not integers: one launch per direction, in order;
    # the same bits in two runs. float32: within f32 rounding of the plain
    # version (1e-3 relative, stated; the plain version sums the directions
    # in pairs). The half forms: the TPU kernel's order of additions and its
    # roundings, so the plain version's bits
    for dtype, want_launches in ((torch.float32, 8), (torch.bfloat16, 12),
                                 (torch.float16, 12)):
        cuda_build.reset_launch_counts()
        first = sgm_cuda.aggregate(cost, 7.5, 30.5, 8, dtype)
        ordered_launches = cuda_build.launch_counts["sgm_path"]
        second = sgm_cuda.aggregate(cost, 7.5, 30.5, 8, dtype)
        want = sgm_cuda.aggregate_plain(cost, 7.5, 30.5, 8, dtype)
        rel = float(((first.float() - want.float()).abs()
                     / want.float().abs().clamp(min=1.0)).max())
        equal = torch.equal(first, want)
        log("kernel K1 fractional penalties", dtype=str(dtype), p1=7.5, p2=30.5,
            launches=ordered_launches, runs_equal=torch.equal(first, second),
            equal_to_plain=equal, max_rel_err=rel,
            ms=cuda_ms(lambda: sgm_cuda.aggregate(cost, 7.5, 30.5, 8, dtype), 20))
        if not (torch.equal(first, second) and rel <= 1e-3
                and ordered_launches == want_launches
                and (equal or dtype == torch.float32)):
            raise AssertionError(f"K1 {dtype} with fractional penalties: runs equal "
                                 f"{torch.equal(first, second)}, equal to plain {equal}, "
                                 f"max rel err {rel}, {ordered_launches} launches")

    disp, valid, val, f0, f1 = _speckle_inputs(device)
    calls = [(val, f0, 0), (val, f1, 1)]
    colrun = sgm_cuda.run_total(val, f0, 0)
    rowrun = sgm_cuda.run_total(val, f1, 1)
    calls += [(colrun, f1, 1), (rowrun, f0, 0)]
    err = 0.0
    for v, st, axis in calls:
        got = sgm_cuda.run_total(v, st, axis)
        want = sgm_cuda.run_total_plain(v, st, axis)
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K2 (axis {axis}) differs from its plain version")
    # a ragged frame (W not a multiple of the warp or of 4), one narrower
    # than a warp, one with fewer rows than a column's 32 lanes, and lines
    # longer than one 512-pixel tile along either axis
    small_shapes = ((61, 77), (40, 20), (9, 300), (600, 36), (3, 1100))
    for h, w in small_shapes:
        v = (torch.rand((h, w), generator=gen) > 0.3).to(torch.float32).to(device)
        st = (torch.rand((h, w), generator=gen) > 0.7).to(torch.float32).to(device)
        for axis in (0, 1):
            if not torch.equal(sgm_cuda.run_total(v, st, axis),
                               sgm_cuda.run_total_plain(v, st, axis)):
                raise AssertionError(f"K2 (axis {axis}) differs from its plain "
                                     f"version at {h}x{w}")
    mask = sgm.speckle_filter(disp, valid, 50, 1.0)
    mask_cpu = sgm.speckle_filter(disp.cpu(), valid.cpu(), 50, 1.0)
    if not torch.equal(mask.cpu(), mask_cpu):
        raise AssertionError("speckle mask on the card differs from the CPU's")

    def four(run):
        return [run(v, st, axis) for v, st, axis in calls]

    ms = cuda_ms(lambda: four(sgm_cuda.run_total), 200)
    plain_ms = cuda_ms(lambda: four(sgm_cuda.run_total_plain), 20)
    # per call: v and start read, the result written; per pixel two scans of
    # an addition and a select each, and the combination (2)
    rows.append(dict(name="speckle_run_total", route="cuda",
                     source="online_3d_reconstruction_tpu_torch/csrc/speckle_run_total.cu",
                     replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:386",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     **bound([val, f0, val] * 4, 4 * 6.0 * val.numel()), library_ms=None))
    log("kernel K2", shape=[384, 512], run_totals_equal=4, mask_equal=True,
        removed=int((valid & ~mask).sum()), max_abs_err=err,
        small_shapes_equal=[list(s) for s in small_shapes])
    rows += _scan_pair_rows(device, gen)
    rows.append(census_cost_row(device))
    rows.append(voxel_reduce_row(device))
    rows.append(ransac_draw_row(device))
    log("kernel times", note="K1, K1half: one 8-path aggregation (2 launches) in "
        "f32 and bf16 storage; K2: the 4 run totals of one speckle filter (4 "
        "launches, host clock between them included); K3 fwd, bwd: one pass each "
        "over the profiler's 384x512x64 f32 vertical pair; K3 pair: both in one launch; "
        "K4: the census of both 384x512 images and the uint8 volume at D = 64, "
        "replayed from a CUDA graph; K5: one reduction of the 2M pool at the "
        "EuRoC cell's grid, its stable sort included, replayed from a CUDA graph; "
        "K6: one frame's 128 x 3 RANSAC indices, replayed from a CUDA graph",
        **{f"{k}_{f}": r[f] for k, r in zip(("K1", "K1half", "K2", "K3fwd", "K3bwd",
                                             "K3pair", "K4", "K5", "K6"), rows)
           for f in ("ms", "plain_ms", "bound_ms")})
    return rows


def _scan_pair_rows(device, gen):
    """K3 against its plain version, bit-equal in f32 and bf16: each pass
    alone (forward, then backward into the forward's result) and the
    one-launch pair, on integer costs 0..32 at the profiler's vertical pair,
    its transposed horizontal pair, ragged shapes (D not a multiple of 32 or
    of 4, D = 128 and 200, fewer lines than a block's chains, odd S, S = 1
    and S = 2), on a skewed volume with 1e9 in its padding cells, and as a
    diagonal round trip (skew, scan pair, deskew) against the aggregation's
    diagonal pair."""
    import torch

    from online_3d_reconstruction_tpu_torch.stereo import sgm, sgm_cuda
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    def integer_cost(shape, dtype):
        return torch.randint(0, 33, shape, generator=gen).to(dtype).to(device)

    shapes = ((384, 512, 64), (512, 384, 64), (37, 45, 40), (33, 70, 128), (5, 3, 8),
              (1, 6, 64), (2, 5, 24), (3, 4, 7), (9, 4, 200))
    volumes = [(f"{shape}", integer_cost(shape, dtype)) for shape in shapes
               for dtype in (torch.float32, torch.bfloat16)]
    for dtype in (torch.float32, torch.bfloat16):
        skewed = sgm._skew(integer_cost((37, 45, 40), torch.float32), 1).to(dtype)
        if not (skewed.shape == (37, 81, 40) and int((skewed > 9e8).sum()) == 37 * 36 * 40):
            raise AssertionError("the skewed volume lacks its 1e9 padding cells")
        volumes.append(("skewed (37, 45, 40)", skewed.contiguous()))
    err_fwd = err_bwd = err_pair = 0.0
    for name, cost in volumes:
        fwd_plain = sgm_cuda.scan_fwd_plain(cost, 8.0, 32.0)
        pair_plain = sgm_cuda.scan_bwd_plain(cost, fwd_plain.clone(), 8.0, 32.0)
        two_pass = torch.empty_like(cost)
        sgm_cuda.scan_launch("scan_fwd", cost, two_pass, 8.0, 32.0)
        fwd = two_pass.clone()
        sgm_cuda.scan_launch("scan_bwd", cost, two_pass, 8.0, 32.0)
        cuda_build.reset_launch_counts()
        pair = sgm_cuda.scan_pair(cost, 8.0, 32.0)
        counts = dict(cuda_build.launch_counts)
        torch.cuda.synchronize()
        if not (counts["scan_pair"] == 1 and counts["scan_fwd"] == counts["scan_bwd"] == 0):
            raise AssertionError(f"scan_pair is not one launch: {counts}")
        err_fwd = max(err_fwd, float((fwd.float() - fwd_plain.float()).abs().max()))
        err_bwd = max(err_bwd, float((two_pass.float() - pair_plain.float()).abs().max()))
        err_pair = max(err_pair, float((pair.float() - pair_plain.float()).abs().max()))
        if not (torch.equal(fwd, fwd_plain) and torch.equal(two_pass, pair_plain)
                and torch.equal(pair, pair_plain)):
            raise AssertionError(f"K3 differs from its plain version at {name} "
                                 f"{cost.dtype}: fwd {err_fwd}, bwd {err_bwd}, "
                                 f"pair {err_pair}")
    # with zero padding cells a border restart is exact, so the round trip is
    # the aggregation's diagonal pair bit for bit
    square = integer_cost((37, 45, 40), torch.float32)
    for sign in (1, -1):
        got = sgm._deskew(sgm_cuda.scan_pair(
            sgm._skew(square, sign, fill=0.0).contiguous(), 8.0, 32.0), sign, 45)
        want = (sgm_cuda._scan_path(square, 8.0, 32.0, False, shift=sign)
                + sgm_cuda._scan_path(square, 8.0, 32.0, True, shift=sign))
        if not torch.equal(got, want):
            raise AssertionError(f"diagonal round trip (sign {sign}) differs from the "
                                 f"diagonal pair: {float((got - want).abs().max())}")
    log("kernel K3", volumes=sorted({name for name, _ in volumes}),
        dtypes=["float32", "bfloat16"], fwd_equal=True, bwd_equal=True, pair_equal=True,
        pair_launches=1, diagonal_round_trip_equal=[1, -1], max_abs_err_fwd=err_fwd,
        max_abs_err_bwd=err_bwd, max_abs_err_pair=err_pair)

    cost = torch.randint(0, 24, (384, 512, 64), generator=gen).float().to(device)
    out = sgm_cuda.scan_fwd_plain(cost, 8.0, 32.0)
    ms_fwd = cuda_ms(lambda: sgm_cuda.scan_launch("scan_fwd", cost, out, 8.0, 32.0), 50)
    ms_bwd = cuda_ms(lambda: sgm_cuda.scan_launch("scan_bwd", cost, out, 8.0, 32.0), 50)
    ms_pair = cuda_ms(lambda: sgm_cuda.scan_pair(cost, 8.0, 32.0), 50)
    plain_fwd = cuda_ms(lambda: sgm_cuda.scan_fwd_plain(cost, 8.0, 32.0), 2, warmup=1)
    plain_bwd = cuda_ms(lambda: sgm_cuda.scan_bwd_plain(cost, out, 8.0, 32.0), 2,
                        warmup=1)
    plain_pair = cuda_ms(lambda: sgm_cuda.scan_pair_plain(cost, 8.0, 32.0), 2, warmup=0)
    horizontal = cost.transpose(0, 1).contiguous()
    half = cost.to(torch.bfloat16)
    log("kernel K3 times", vertical_pair_ms=ms_pair,
        horizontal_pair_ms=cuda_ms(lambda: sgm_cuda.scan_pair(horizontal, 8.0, 32.0), 50),
        vertical_pair_bf16_ms=cuda_ms(lambda: sgm_cuda.scan_pair(half, 8.0, 32.0), 50))
    source = "online_3d_reconstruction_tpu_torch/csrc/sgm_scan_pair.cu"
    pallas = "online_3d_reconstruction_tpu/stereo/sgm_pallas.py"
    # fwd reads the cost and writes the result; bwd reads both and writes;
    # the pair as one function reads the cost and writes the total. Per cell
    # and chain 4 fminf, 4 additions and its share of the min over D (2);
    # one more addition joins the chains
    return [dict(name="sgm_scan_fwd", route="cuda", source=source,
                 replaces=f"{pallas}:63", max_abs_err=err_fwd, ms=ms_fwd,
                 plain_ms=plain_fwd, **bound([cost, out], 10.0 * cost.numel()),
                 library_ms=None),
            dict(name="sgm_scan_bwd", route="cuda", source=source,
                 replaces=f"{pallas}:79", max_abs_err=err_bwd, ms=ms_bwd,
                 plain_ms=plain_bwd, **bound([cost, out, out], 11.0 * cost.numel()),
                 library_ms=None),
            dict(name="sgm_scan_pair", route="cuda", source=source,
                 replaces=f"{pallas}:63 and {pallas}:79", max_abs_err=err_pair,
                 ms=ms_pair, plain_ms=plain_pair,
                 **bound([cost, out], 21.0 * cost.numel()), library_ms=None)]


def _census_pair(h: int, w: int, gen):
    """A left image in steps of 1/255, a third of it flat 4x4 patches (ties
    in every window there), and a right image that is it shifted by 7
    columns with a tenth of its pixels redrawn."""
    import torch

    base = torch.randint(0, 256, (h, w), generator=gen)
    flat = base[::4, ::4].repeat_interleave(4, 0).repeat_interleave(4, 1)[:h, :w]
    left = torch.where(torch.rand((h, w), generator=gen) < 0.33, flat, base)
    right = torch.roll(left, -7, 1)
    redraw = torch.rand((h, w), generator=gen) < 0.1
    right = torch.where(redraw, torch.randint(0, 256, (h, w), generator=gen), right)
    return left.float() / 255.0, right.float() / 255.0


def census_cost_row(device) -> dict:
    """K4 against its plain chain (``census_transform`` x2 + ``cost_volume``
    + uint8), bit-equal at the cells' shapes, 384x512 and 480x752 at D =
    64, and at 384x512 at D = 128, then at ragged shapes (one tile and
    several, D not a multiple of 16, D = 1 and 256) and windows (3x3, 7x3,
    3x11 and 1x33: run-time radii, bit 31); its time alone at each cell's
    shape, launches replayed from a CUDA graph (and back to back from the
    host, for comparison), beside the compulsory bytes (both f32 images in,
    the uint8 volume out, at 3.35 TB/s) and the plain chain's time."""
    import torch

    from online_3d_reconstruction_tpu_torch.stereo import sgm_cuda
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    gen = torch.Generator().manual_seed(4)
    times = {}
    for h, w, d in ((384, 512, 64), (480, 752, 64), (384, 512, 128)):
        left, right = (x.to(device) for x in _census_pair(h, w, gen))
        cuda_build.reset_launch_counts()
        got = sgm_cuda.census_cost(left, right, (5, 5), d)
        launches = cuda_build.launch_counts["census_cost"]
        want = sgm_cuda.census_cost_plain(left, right, (5, 5), d)
        torch.cuda.synchronize()
        if not (launches == 1 and got.dtype == torch.uint8 and torch.equal(got, want)):
            raise AssertionError(f"K4 at {h}x{w}x{d}: {launches} launches, or differs from "
                                 f"its plain chain at "
                                 f"{int((got != want).sum())} of {want.numel()} cells")
        times[h, w, d] = dict(
            ms=graph_ms(lambda: sgm_cuda.census_cost(left, right, (5, 5), d)),
            eager_ms=cuda_ms(lambda: sgm_cuda.census_cost(left, right, (5, 5), d), 100),
            plain_ms=cuda_ms(lambda: sgm_cuda.census_cost_plain(left, right, (5, 5), d), 5,
                             warmup=1),
            **bound([left, right, got], 0.0))
        times[h, w, d]["share_of_bound"] = times[h, w, d]["bound_ms"] / times[h, w, d]["ms"]
        log("kernel K4", shape=[h, w, d], window=[5, 5], equal=True, **times[h, w, d])
    ragged = ((37, 45, 64, (5, 5)), (9, 300, 40, (7, 3)), (6, 131, 128, (3, 11)),
              (5, 140, 256, (3, 3)), (4, 70, 1, (5, 5)), (33, 200, 24, (1, 33)))
    for h, w, d, window in ragged:
        left, right = (x.to(device) for x in _census_pair(h, w, gen))
        if not torch.equal(sgm_cuda.census_cost(left, right, window, d),
                           sgm_cuda.census_cost_plain(left, right, window, d)):
            raise AssertionError(f"K4 differs from its plain chain at {h}x{w}x{d}, "
                                 f"window {window}")
    log("kernel K4 ragged", cases=[[h, w, d, list(win)] for h, w, d, win in ragged],
        equal=True)
    main = times[384, 512, 64]
    return dict(name="census_cost", route="cuda",
                source="online_3d_reconstruction_tpu_torch/csrc/census_cost.cu",
                replaces=None, entry_points=["o3r_census_cost"], max_abs_err=0.0,
                **main, library_ms=None,
                shapes={"x".join(map(str, shape)): t for shape, t in times.items()})


# K5's pools: the main 2M pool as a flush leaves it for ``downsample_map``
# (the map's voxels as the cells' program traces count them after a
# downsample: ~765k EuRoC, ~1.64M survey)
# (one entry per voxel of the map, then the flush's survivors, a share of them
# in voxels the map lacked, then empty slots) and a staging pool (8 frames of
# backprojected points, a quarter invalid), each on its cell's grid
VOXEL_POOLS = {
    # name: (slots, voxel m, bounds m, map voxels, survivors, new share, points a voxel)
    "euroc_main_2m": (2_000_000, 0.025, 204.8, 765_000, 60_000, 0.3, None),
    "survey_main_2m": (2_000_000, 0.25, 2048.0, 1_640_000, 40_000, 0.3, None),
    "euroc_staging": (721_920, 0.025, 204.8, None, None, None, 30),
    "survey_staging": (393_216, 0.25, 2048.0, None, None, None, 12),
}


def voxel_pool(name: str, gen, device):
    """One of ``VOXEL_POOLS`` on ``device``: positions uniform in their
    voxels (on a slab of the grid a few voxels deep, so the keys spread as a
    noisy surface's do), colors uniform, invalid slots zero."""
    import torch

    from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud

    n, size, bounds, voxels, survivors, new, per_voxel = VOXEL_POOLS[name]
    if per_voxel is None:
        ids = torch.cat([torch.arange(voxels),
                         torch.randint(0, voxels, (survivors - int(new * survivors),),
                                       generator=gen).sort().values,
                         voxels + torch.arange(int(new * survivors))])
        valid = torch.ones(len(ids), dtype=torch.bool)
    else:
        valid = torch.rand(n, generator=gen) >= 0.25
        ids = torch.randint(0, max(int(valid.sum()) // per_voxel, 1), (n,), generator=gen)
    depth = 6
    side = int(np.ceil(np.sqrt((int(ids.max()) + 1) / depth))) + 1
    cell = torch.stack([ids // (side * depth), (ids // depth) % side, ids % depth], 1)
    origin = torch.tensor([-(side // 2), -(side // 2), -120.0]) * size   # on the grid
    pts = origin + (cell + torch.rand(cell.shape, generator=gen)) * size
    pts = torch.where(valid[:, None], pts, 0.0)
    cols = torch.where(valid[:, None], torch.rand(cell.shape, generator=gen), 0.0)
    pad = n - len(ids)
    cloud = PointCloud(torch.cat([pts, torch.zeros((pad, 3))]).float(),
                       torch.cat([cols, torch.zeros((pad, 3))]).float(),
                       torch.cat([valid, torch.zeros(pad, dtype=torch.bool)]))
    return PointCloud(*(t.to(device).contiguous() for t in cloud)), size, bounds


def voxel_reduce_row(device) -> dict:
    """K5 against the plain reduction on the CPU, bit-equal on each pool of
    ``VOXEL_POOLS``: given the keys PyTorch computes on the card
    (``voxel_keys`` run there), ``segment_centroids_plain`` on a CPU copy;
    where 1 / voxel size is exact (the survey's 0.25 m) also
    ``voxel_downsample_plain`` on the CPU copy whole, and elsewhere the count
    of points whose CPU key differs. One K5 counted per call. Its time
    replayed from a CUDA graph and back to back from the host, the stable
    sort's and the cumsum's alone (the rest is K5's three kernels), the plain
    form's on the card (``index_add_``), beside the compulsory bytes (the
    pool in, the reduced pool out, at 3.35 TB/s)."""
    import torch

    from online_3d_reconstruction_tpu_torch.mapping import voxel
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    gen = torch.Generator().manual_seed(5)
    times = {}
    for name in VOXEL_POOLS:
        cloud, size, bounds = voxel_pool(name, gen, device)
        before = cuda_build.launch_counts["voxel_reduce"]
        got = voxel.voxel_downsample(cloud, size, bounds)
        launches = cuda_build.launch_counts["voxel_reduce"] - before
        card_keys = voxel.voxel_keys(cloud, size, bounds)
        cpu = type(cloud)(*(t.cpu() for t in cloud))
        want = voxel.segment_centroids_plain(cpu, card_keys.cpu())
        got_cpu = [t.cpu() for t in got]

        def same(a, b):
            return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                       for x, y in zip(a, b))

        keys_differ = int((voxel.voxel_keys(cpu, size, bounds) != card_keys.cpu()).sum())
        whole = same(got_cpu, voxel.voxel_downsample_plain(cpu, size, bounds))
        if not (launches == 1 and same(got_cpu, want) and (whole or keys_differ > 0)):
            raise AssertionError(f"K5 on {name}: {launches} launches, or differs from the "
                                 f"plain reduction at {int((got_cpu[0] != want.points).sum())} "
                                 f"coordinates; whole plain form equal: {whole} with "
                                 f"{keys_differ} keys differing")
        key = voxel.voxel_keys(cloud, size, bounds)
        head = torch.ones(len(key), dtype=torch.int32, device=device)
        t = dict(
            ms=graph_ms(lambda: voxel.voxel_downsample(cloud, size, bounds), calls=10),
            eager_ms=cuda_ms(lambda: voxel.voxel_downsample(cloud, size, bounds), 20),
            sort_ms=graph_ms(lambda: torch.sort(key, stable=True), calls=10),
            cumsum_ms=graph_ms(lambda: torch.cumsum(head, 0, dtype=torch.int32), calls=10),
            plain_ms=cuda_ms(lambda: voxel.voxel_downsample_plain(cloud, size, bounds), 10),
            **bound(list(cloud) + list(got), 0.0))
        t.update(kernels_ms=t["ms"] - t["sort_ms"] - t["cumsum_ms"],
                 share_of_bound=t["bound_ms"] / t["ms"], slots=len(key),
                 valid=int(cloud.valid.sum()), voxels=int(got.valid.sum()),
                 equal=True, whole_plain_equal=whole, cpu_keys_differ=keys_differ)
        times[name] = t
        log("kernel K5", pool=name, **t)
    main = times["euroc_main_2m"]
    return dict(name="voxel_reduce", route="cuda",
                source="online_3d_reconstruction_tpu_torch/csrc/voxel_reduce.cu",
                replaces=None, entry_points=["o3r_voxel_keys", "o3r_voxel_heads",
                                             "o3r_voxel_reduce"],
                max_abs_err=0.0, **main, library_ms=None, pools=times)


# K6's draws: seeds, frame indices (2^31 + 3 past int32), n (1, 3, the cells'
# 512 keypoints, 2000) and hypotheses a frame
DRAW_CASES = dict(seeds=(0, 7, 2**32 - 1), frames=(0, 5, 2**31 + 3), n=(1, 3, 512, 2000),
                  iters=(1, 128))


def ransac_draw_row(device) -> dict:
    """K6 against ``hypothesis_indices_plain``, bit-equal on the card and to
    the CPU's plain form for every case of ``DRAW_CASES``, one launch
    counted a call; its time alone at 128 hypotheses of 512 matches and the
    plain chain's, both replayed from a CUDA graph. Its bound is latency
    (one thread's five threefry hashes): the bytes (the index in, 3 KB out)
    take ~1 ns at 3.35 TB/s."""
    import itertools

    import torch

    from online_3d_reconstruction_tpu_torch.odometry import rigid
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    cases = list(itertools.product(*DRAW_CASES.values()))
    for seed, frame, n, iters in cases:
        idx = torch.tensor(frame, device=device)
        before = cuda_build.launch_counts["ransac_draw"]
        got = rigid.hypothesis_indices(seed, idx, iters, n)
        launches = cuda_build.launch_counts["ransac_draw"] - before
        want = rigid.hypothesis_indices_plain(seed, idx, iters, n)
        cpu = rigid.hypothesis_indices_plain(seed, idx.cpu(), iters, n)
        if not (launches == 1 and torch.equal(got, want) and torch.equal(got.cpu(), cpu)):
            raise AssertionError(f"K6 at seed {seed}, frame {frame}, n {n}, iters {iters}: "
                                 f"{launches} launches, or differs from its plain chain at "
                                 f"{int((got != want).sum())} of {want.numel()} values")
    idx = torch.tensor(12, device=device)
    out = rigid.hypothesis_indices(7, idx, 128, 512)
    t = dict(ms=graph_ms(lambda: rigid.hypothesis_indices(7, idx, 128, 512)),
             plain_ms=graph_ms(lambda: rigid.hypothesis_indices_plain(7, idx, 128, 512),
                               calls=5),
             **bound([idx, out], 0.0))
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    log("kernel K6", cases=len(cases), equal=True, iters=128, n=512, **t)
    return dict(name="ransac_draw", route="cuda",
                source="online_3d_reconstruction_tpu_torch/csrc/ransac_fit.cu",
                replaces=None, entry_points=["o3r_ransac_draw"], max_abs_err=0.0,
                latency_bound=True, **t, library_ms=None)


def _within_fit(got, want) -> bool:
    """K7's tolerance: T to 1e-5 x (1 + |entry|), the weights to 1e-5
    relative (zeros exact)."""
    (t, w), (t_want, w_want) = ([x.double().cpu() for x in pair] for pair in (got, want))
    return bool(((t - t_want).abs() <= 1e-5 * (1 + t_want.abs())).all()
                and ((w - w_want).abs() <= 1e-5 * w_want.abs()).all())


def rigid_irls_row(device, frames, rig, cfg) -> dict:
    """K7 against ``irls_fit_plain``, on the card and on a CPU copy, within
    ``_within_fit``: on one frame's real matches (the second frame of the
    main path tracked against the first, N = 512, caught at the call) and on
    random matches with 30% outliers at N = 517 and 2000; the identity and
    zero weights, exactly, for zero weights; one launch counted a call. Its
    time alone on the real matches and the plain chain's, both replayed
    from a CUDA graph. Its bound is latency (4 fits, each 3 block sums and
    24 dependent 4x4 float64 squarings): the bytes (~14 KB) take ~4 ns."""
    import torch

    from online_3d_reconstruction_tpu_torch.odometry import rigid
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import OnlineReconstructor
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    caught = []
    fit = rigid.irls_fit

    def catch(*args):
        caught.append(args)
        return fit(*args)

    rigid.irls_fit = catch
    try:
        engine = OnlineReconstructor(cfg, rig, device, _step="eager")
        for frame in frames[:2]:
            engine.process(frame)
        torch.cuda.synchronize()
        del engine
    finally:
        rigid.irls_fit = fit
    gen = torch.Generator().manual_seed(6)

    def outliers(n):
        src = torch.rand((n, 3), generator=gen) * 30.0 + torch.tensor([-15.0, -15.0, 10.0])
        c, s = math.cos(0.2), math.sin(0.2)
        rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        dst = (src @ rot.T + torch.tensor([1.0, -0.5, 0.8])
               + 0.02 * torch.randn((n, 3), generator=gen))
        bad = torch.rand(n, generator=gen) < 0.3
        dst = torch.where(bad[:, None], torch.rand((n, 3), generator=gen) * 50 - 10, dst)
        valid = torch.rand(n, generator=gen) >= 0.2
        weights = 0.25 ** torch.randint(0, 3, (n,), generator=gen).float()
        return tuple(x.to(device) for x in (src, dst, valid & ~bad, valid, weights))

    cases = {"frame_1_matches": caught[-1][:5], "outliers_517": outliers(517),
             "outliers_2000": outliers(2000)}
    threshold = caught[-1][5]
    for name, args in cases.items():
        before = cuda_build.launch_counts["rigid_irls"]
        got = rigid.irls_fit(*args, threshold)
        launches = cuda_build.launch_counts["rigid_irls"] - before
        want = rigid.irls_fit_plain(*args, threshold)
        cpu = rigid.irls_fit_plain(*(x.cpu() for x in args), threshold)
        if not (launches == 1 and _within_fit(got, want) and _within_fit(got, cpu)):
            raise AssertionError(f"K7 on {name}: {launches} launches, or T off by "
                                 f"{float((got[0] - want[0]).abs().max())}, weights by "
                                 f"{float((got[1] - want[1]).abs().max())}")
        log("kernel K7 case", case=name, n=int(args[0].shape[0]),
            valid=int(args[3].sum()), inliers=int(args[2].sum()),
            t_max_abs_err=float((got[0] - want[0]).abs().max()),
            w_max_rel_err=float(((got[1] - want[1]).abs()
                                 / want[1].abs().clamp(min=1e-30)).max()))
    src, dst, mask, valid, weights = cases["frame_1_matches"]
    t_zero, w_zero = rigid.irls_fit(src, dst, mask, valid, torch.zeros_like(weights),
                                    threshold)
    if not (torch.equal(t_zero, torch.eye(4, device=device)) and not bool(w_zero.any())):
        raise AssertionError(f"K7 on zero weights: {t_zero.cpu()}, weights {w_zero.cpu()}")
    args = cases["frame_1_matches"]
    got = rigid.irls_fit(*args, threshold)
    t = dict(ms=graph_ms(lambda: rigid.irls_fit(*args, threshold)),
             plain_ms=graph_ms(lambda: rigid.irls_fit_plain(*args, threshold), calls=5),
             **bound(list(args) + list(got), 0.0))
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    log("kernel K7", n=int(src.shape[0]), threshold=threshold, zero_weights_identity=True,
        **t)
    return dict(name="rigid_irls", route="cuda",
                source="online_3d_reconstruction_tpu_torch/csrc/ransac_fit.cu",
                replaces=None, entry_points=["o3r_rigid_irls"],
                max_abs_err=float((got[0] - rigid.irls_fit_plain(*args, threshold)[0]).abs().max()),
                latency_bound=True, **t, library_ms=None)


def phase_main_path(device):
    import torch

    from online_3d_reconstruction_tpu_torch.config import PipelineConfig
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import reconstruct
    from online_3d_reconstruction_tpu_torch.stereo import sgm
    from online_3d_reconstruction_tpu_torch.stereo.rectify import rectify_pair
    from online_3d_reconstruction_tpu_torch.utils import cuda_build
    from online_3d_reconstruction_tpu_torch.utils.metrics import ate_rmse

    h, w, d = 384, 512, 64
    rig, data = make_sequence(h, w, 400.0, N_WARMUP + N_TIMED, 30.0, 1.2)
    t0 = time.perf_counter()
    frames = render_frames(data)
    log("render", frames=len(frames), host_s=time.perf_counter() - t0)
    cfg = make_config(h, w, d, 512, 2_000_000, ba=True)
    n = len(frames)
    gt = np.stack([f.gt_pose for f in frames])
    priors = np.stack([f.prior_pose for f in frames])
    ate_prior = ate_rmse(priors, gt)

    # the user's entry point, with the launch counters read around it: at the
    # default configuration (bf16 aggregation), then at cost_dtype="float32"
    runs = {}
    for cost_dtype in ("bfloat16", "float32"):
        cuda_build.reset_launch_counts()
        res = reconstruct(frames, cfg if cost_dtype == "bfloat16" else
                          make_config(h, w, d, 512, 2_000_000, ba=True, cost_dtype=cost_dtype),
                          rig, device=device)
        launches = dict(cuda_build.launch_counts)
        # K5 reduces every flush and downsample, finish's one of each at least
        if launches["voxel_reduce"] < 2:
            raise AssertionError(f"{launches['voxel_reduce']} K5 reductions in the main path "
                                 f"({cost_dtype})")
        want = dict(LAUNCHES_PER_FRAME, sgm_path_half=LAUNCHES_PER_FRAME["sgm_path"]
                    if cost_dtype == "bfloat16" else 0)
        for name, k in want.items():
            if launches[name] != n * k:
                raise AssertionError(f"{name}: {launches[name]} launches in the main "
                                     f"path ({cost_dtype}), expected {n} frames x {k}")
        # K6 and K7 on every tracked frame: all but the first
        for name, k in TRACKING_LAUNCHES_PER_FRAME.items():
            if launches[name] != (n - 1) * k:
                raise AssertionError(f"{name}: {launches[name]} launches in the main "
                                     f"path ({cost_dtype}), expected {n - 1} tracked "
                                     f"frames x {k}")
        ate = ate_rmse(res.trajectory, gt)
        if not (np.isfinite(ate) and np.isfinite(res.trajectory).all()):
            raise AssertionError(f"non-finite trajectory / ATE {ate}")
        if res.trajectory.shape != (n, 4, 4) or not np.isfinite(res.map_points).all():
            raise AssertionError("trajectory or map has the wrong shape or non-finite points")
        log("main path", entry="reconstruct(device='cuda')", cost_dtype=cost_dtype,
            frames=n, resolution=f"{w}x{h}x{d}", paths=cfg.stereo.num_paths,
            rectify="distorted rig",
            window_ba=dict(window=cfg.ba.window, max_landmarks=cfg.ba.max_landmarks,
                           gn_iters=cfg.ba.gn_iters),
            keyframes=len(res.keyframe_indices), map_points=int(len(res.map_points)),
            launches=launches, launches_per_frame={k: v / n for k, v in launches.items()},
            ate_m=ate, ate_prior_only_m=ate_prior, ate_over_prior=ate / ate_prior,
            reference_ate_m=REF_ATE_FULL,
            reference_ate_over_prior=REF_ATE_FULL / REF_ATE_PRIOR,
            ate_aligned_m=ate_rmse(res.trajectory, gt, align=True))
        if not ate <= 0.5 * ate_prior:
            raise AssertionError(f"full-stack ATE {ate} m ({cost_dtype}) is above 0.5x "
                                 f"prior-only ({ate_prior} m)")
        # the kernels are bit-equal to their plain versions or, K7, sum in a
        # fixed order, so the trajectory cannot move: other digits mean a
        # fault in a kernel, not noise
        want_ate, want_points = PORT_RUNS[cost_dtype]
        if abs(ate - want_ate) > 5e-8:
            raise AssertionError(f"full-stack ATE {ate:.8f} m ({cost_dtype}) differs from "
                                 f"the port's {want_ate:.8f} m")
        if abs(len(res.map_points) - want_points) > 0.005 * want_points:
            raise AssertionError(f"{len(res.map_points)} map points ({cost_dtype}), "
                                 f"expected {want_points} within 0.5%")
        runs[cost_dtype] = (res, launches, ate)
    result, launches, ate = runs["bfloat16"]

    # the VO-only ablation (window BA off), the benchmark's attribution row
    vo = reconstruct(frames, make_config(h, w, d, 512, 2_000_000, ba=False), rig,
                     device=device)
    ate_vo = ate_rmse(vo.trajectory, gt)
    log("vo-only ablation", frames=n, ate_m=ate_vo, reference_ate_m=REF_ATE_VO,
        ate_aligned_m=ate_rmse(vo.trajectory, gt, align=True),
        ate_prior_aligned_m=ate_rmse(priors, gt, align=True))
    if not (np.isfinite(ate_vo) and ate < ate_vo):
        raise AssertionError(f"window BA did not improve on VO only: {ate} vs {ate_vo}")

    # the library's default configuration (window BA on, W=16) runs as it is
    default = reconstruct(frames[:N_WARMUP], PipelineConfig(), rig, device=device)
    if not (default.trajectory.shape == (N_WARMUP, 4, 4)
            and np.isfinite(default.trajectory).all()):
        raise AssertionError("the default configuration gave no finite trajectory")
    log("default config", frames=N_WARMUP, keyframes=len(default.keyframe_indices),
        ate_m=ate_rmse(default.trajectory, gt[:N_WARMUP]))

    # disparity quality on one frame, against the scene's ground truth
    f0 = frames[N_WARMUP]
    left_r, right_r = rectify_pair(
        torch.as_tensor(f0.left, device=device), torch.as_tensor(f0.right, device=device),
        torch.as_tensor(rig.map_left, device=device),
        torch.as_tensor(rig.map_right, device=device))
    disp, valid = sgm.sgm_disparity(left_r, right_r, cfg.stereo)
    disp, valid = disp.cpu().numpy(), valid.cpu().numpy()
    gt_d = f0.disparity   # the scene's exact rectified-left disparity
    ok = valid & (gt_d > 0)
    density = float(ok.mean())
    bad1 = float((np.abs(disp[ok] - gt_d[ok]) > 1.0).mean())
    log("disparity", frame=N_WARMUP, density=density, bad_1px=bad1)
    if not (density > 0.9 and bad1 < 0.02):
        raise AssertionError(f"disparity below the bars: density {density}, "
                             f"bad>1px {bad1}")

    phase_step_graph(device, frames, rig, cfg, result, launches, gt, ate_prior)
    return launches, runs["float32"][1], frames, data, cfg, result, ate, ate_vo


def phase_step_graph(device, frames, rig, cfg, graph_result, graph_launches, gt,
                     ate_prior: float) -> None:
    """The main path's default run (``reconstruct``: every steady frame a
    replay of a captured CUDA graph) against the same frames through the
    eager step (``_step="eager"``): the graphs captured (at most one per
    variant, each variant's first frame eager), every other steady frame a
    replay, the K1/K2 launches counted through the replays equal to the
    eager run's, the trajectory within 1e-4 m and 1e-4 rad (the resume
    tolerance) and the map size within 0.5% of eager's, ATE <= 0.5x
    prior-only."""
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
        OnlineReconstructor, run_frames)
    from online_3d_reconstruction_tpu_torch.utils import cuda_build
    from online_3d_reconstruction_tpu_torch.utils.metrics import ate_rmse

    n = len(frames)
    cuda_build.reset_launch_counts()
    engine = OnlineReconstructor(cfg, rig, device, _step="eager")
    run_frames(engine, frames)
    eager = engine.finish()
    eager_launches = dict(cuda_build.launch_counts)
    stats = graph_result.metrics.get("step_graph")
    if not stats:
        raise AssertionError("the default run on the card captured no step graph")
    variants = stats["variants"]
    keys = [tuple(v[k] for k in ("fuse", "ba_event", "keyframe", "precomputed_disp",
                                  "skip_rectify")) for v in variants]
    captures = stats["captures"]
    # frame 0 is the first frame (eager by design); each variant's first
    # steady frame runs eagerly before its capture; every other is a replay
    if not (captures == len(set(keys)) == len(keys) >= 1
            and stats["replays"] == n - 1 - captures):
        raise AssertionError(f"step graph: {captures} captures of {len(set(keys))} "
                             f"variants, {stats['replays']} replays of {n - 1} steady "
                             "frames")
    dt = np.linalg.norm(graph_result.trajectory[:, :3, 3] - eager.trajectory[:, :3, 3],
                        axis=1)
    dr = rotation_angle(graph_result.trajectory, eager.trajectory)
    ate_graph = ate_rmse(graph_result.trajectory, gt)
    ate_eager = ate_rmse(eager.trajectory, gt)
    log("step graph", frames=n, captures=captures, replays=stats["replays"],
        variants=variants,
        capture_ms=[v["capture_ms"] for v in variants],
        graph_mib=[v["graph_mib"] for v in variants],
        launches_graph=graph_launches, launches_eager=eager_launches,
        max_dt_m=float(dt.max()), max_drot_rad=float(dr.max()),
        map_points_graph=len(graph_result.map_points), map_points_eager=len(eager.map_points),
        ate_graph_m=ate_graph, ate_eager_m=ate_eager, ate_prior_only_m=ate_prior)
    for name in ("census_cost", "sgm_path", "sgm_path_half", "run_total",
                 *TRACKING_LAUNCHES_PER_FRAME):
        if graph_launches[name] != eager_launches[name]:
            raise AssertionError(f"{name}: {graph_launches[name]} launches counted through "
                                 f"the replays, {eager_launches[name]} eager")
    if not (dt.max() <= 1e-4 and dr.max() <= 1e-4):
        raise AssertionError(f"graph and eager trajectories differ by {dt.max()} m, "
                             f"{dr.max()} rad")
    n_g, n_e = len(graph_result.map_points), len(eager.map_points)
    if abs(n_g - n_e) > 0.005 * n_e:
        raise AssertionError(f"map sizes {n_g} (graph) and {n_e} (eager)")
    if not (ate_graph <= 0.5 * ate_prior and ate_eager <= 0.5 * ate_prior):
        raise AssertionError(f"ATE {ate_graph} (graph), {ate_eager} (eager) above 0.5x "
                             f"prior-only ({ate_prior})")


# ---------------------------------------------------------------------------
# the bench and the profilers of the steady frame and of the disparity stage
# ---------------------------------------------------------------------------

def phase_bench(device, frames, main, ate_vo: float, k1_ms: float) -> None:
    """Item 5 of the module docstring: ``bench.main`` on the main path's
    frames (the bench's own scene and configuration), its one stdout line
    parsed. ``main`` is the main path's (result, ATE) at the default
    configuration, ``ate_vo`` its VO-only ATE and ``k1_ms`` the kernel
    phase's time of K1's bf16 form (the bench's K1 row)."""
    import contextlib
    import io

    from online_3d_reconstruction_tpu_torch import bench
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    runs = []
    run_engine = bench._run_engine

    def counted(*args, **kw):
        before = dict(cuda_build.launch_counts)
        out = run_engine(*args, **kw)
        runs.append({k: v - before[k] for k, v in cuda_build.launch_counts.items()})
        return out

    detail_path = ROOT / "build" / "bench_smoke" / "BENCH_DETAIL_TORCH.json"
    detail_path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.StringIO()
    bench._run_engine = counted
    cuda_build.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(buf):
            detail = bench.main(["--device", str(device), "--detail", str(detail_path)],
                                setup=bench._make_bench_setup(device), frames=frames)
    finally:
        bench._run_engine = run_engine
    total = dict(cuda_build.launch_counts)
    lines = buf.getvalue().splitlines()
    line = json.loads(lines[-1])
    ate = detail["ate_m"]
    kernels = detail["kernels"]
    n = len(frames)
    log("bench", entry=f"bench.main(--device {device})", line=line,
        frames_per_s_device_resident=detail["frames_per_s_device_resident"],
        frame_attribution_ms=detail["frame_attribution_ms"], ate_m=ate,
        ate_over_prior=ate["full_stack"] / ate["prior_only_dead_reckoning"],
        map_points=detail["map_points"], stage_means_ms=detail["stage_means_ms"],
        launches=total, launches_per_run=runs, device=detail["device"],
        kernels={name: {k: row.get(k) for k in ("time_ms", "binding_roof",
                                                "pct_of_binding_roof", "ba_iters_per_s",
                                                "invalid", "notes")}
                 for name, row in kernels.items()}, kernel_phase_k1_ms=k1_ms)
    if not (len(lines) == 1 and list(line) == ["metric", "value", "unit", "vs_baseline"]
            and line["value"] > 0):
        raise AssertionError(f"bench stdout {lines}")
    main_result, main_ate = main
    if not (abs(ate["full_stack"] - main_ate) <= 5e-8
            and ate["full_stack"] <= 0.5 * ate["prior_only_dead_reckoning"]):
        raise AssertionError(f"bench full-stack ATE {ate}")
    if not abs(ate["vo_only_no_ba"] - ate_vo) <= 5e-8:
        raise AssertionError(f"bench VO-only ATE {ate['vo_only_no_ba']} differs from the "
                             f"ablation's {ate_vo}")
    points = len(main_result.map_points)
    if abs(detail["map_points"] - points) > 0.005 * points:
        raise AssertionError(f"bench map {detail['map_points']} points, expected "
                             f"the main path's {points} within 0.5%")
    want = {name: n * k for name, k in LAUNCHES_PER_FRAME.items()}
    if len(runs) != 3 or any(run[k] != v for run in runs for k, v in want.items()):
        raise AssertionError(f"bench runs launched {runs}, expected {want} each")
    bad = [name for name, row in kernels.items() if "invalid" in row]
    k1 = kernels.get("sgm_aggregation", {}).get("time_ms", float("nan"))
    if len(kernels) != 5 or bad or not 0.5 <= k1 / k1_ms <= 2.0:
        raise AssertionError(f"bench kernel rows: {len(kernels)}, invalid {bad}, K1 "
                             f"{k1} ms against the kernel phase's {k1_ms} ms")


def _reference_rows(tool: str, pattern: str) -> list:
    return re.findall(pattern, (ROOT / "tools" / tool).read_text())


def _rows_match(rows, want) -> bool:
    """Every reference row, in order, under its name or its name and the
    port's form; every time finite and > 0."""
    ported = [name for name, _ in rows
              if any(name == r or name.startswith(r + " [port: ") for r in want)]
    return (len(ported) == len(want)
            and all(n == r or n.startswith(r + " [port: ") for n, r in zip(ported, want))
            and all(np.isfinite(ms) and ms > 0 for _, ms in rows))


def phase_steady_profilers(device, frames) -> None:
    """Item 6 of the module docstring."""
    import contextlib
    import io

    from online_3d_reconstruction_tpu_torch import bench
    from online_3d_reconstruction_tpu_torch.tools import profile_stage_parts, profile_steady
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    setup = bench._make_bench_setup(device)
    cfg = setup[4]
    rows, _, steady = _tool(profile_steady.main, [], device, setup=setup,
                            frames=frames[:N_WARMUP + 2])
    names = _reference_rows("profile_steady.py", r'report\(f?"([^"]+)"')
    names += _reference_rows("profile_steady.py", r'\("(FUSED [^"]+)", steady')
    scope = dict(ds_every=cfg.mapping.downsample_every, wt=cfg.ba.window,
                 lt=cfg.ba.max_landmarks, cfg=cfg)
    want = [eval("f" + repr(name), {}, scope) for name in names]
    log("profile_steady", entry="tools.profile_steady.main(bench setup, frame 12)",
        row_ms=dict(rows), launches=steady)
    # each timed step is one frame's disparity: K1 2 and K2 4 launches a step
    steps = steady["sgm_path"] // LAUNCHES_PER_FRAME["sgm_path"]
    if not (len(want) == 7 and len(rows) == 7 and _rows_match(rows, want) and steps > 0
            and steady["run_total"] == steps * LAUNCHES_PER_FRAME["run_total"]):
        raise AssertionError(f"profile_steady rows {rows} against {want}, launches {steady}")

    buf = io.StringIO()
    cuda_build.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rows = profile_stage_parts.main(384, 512, 64, device=device)
    parts = dict(cuda_build.launch_counts)
    want = _reference_rows("profile_stage_parts.py", r'print\(f"(.+?): \{sec')
    log("profile_stage_parts", entry="tools.profile_stage_parts.main(384, 512, 64)",
        row_ms=dict(rows), launches=parts)
    if not (len(want) == 8 and _rows_match(rows, want)
            and parts["sgm_path"] > 0 and parts["run_total"] > 0):
        raise AssertionError(f"profile_stage_parts rows {rows} against {want}, "
                             f"launches {parts}")


# ---------------------------------------------------------------------------
# the apps phase: the user's entry points on a disk folder
# ---------------------------------------------------------------------------

def _quaternion_wxyz(r: np.ndarray) -> list:
    """Unit quaternion (w, x, y, z) of a rotation matrix (Shepperd, float64)."""
    r = r.astype(np.float64)
    tr = np.trace(r)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        return [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s]
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12))
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q.tolist()


def write_disk_folder(root: Path, frames, calib, cfg) -> dict:
    """The rendered frames as a user's flight folder: left as (H, W, 3)
    float32 .npy and right as gray .npy named by timestamp, the scene's
    exact disparity as .npy, a flight-log CSV (timestamp,x,y,z,qw,qx,qy,qz)
    of the frames' priors, the rig's calibration JSON and the configuration
    as a JSON of its values."""
    import dataclasses
    import shutil

    if root.exists():
        shutil.rmtree(root)
    paths = {name: root / name for name in ("left", "right", "disp")}
    for path in paths.values():
        path.mkdir(parents=True)
    rows = []
    for f in frames:
        stamp = f"{f.timestamp:.6f}"
        np.save(paths["left"] / f"{stamp}.npy", f.color.astype(np.float32))
        np.save(paths["right"] / f"{stamp}.npy", f.right.astype(np.float32))
        np.save(paths["disp"] / f"{stamp}.npy", f.disparity.astype(np.float32))
        rows.append([f.timestamp, *f.prior_pose[:3, 3].tolist(),
                     *_quaternion_wxyz(f.prior_pose[:3, :3])])
    with open(root / "log.csv", "w") as fh:
        fh.write("timestamp,x,y,z,qw,qx,qy,qz\n")
        for row in rows:
            fh.write(",".join(repr(float(v)) for v in row) + "\n")

    def cam(c):
        return dict(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height,
                    dist=list(c.dist))

    with open(root / "calib.json", "w") as fh:
        json.dump({"left": cam(calib.left), "right": cam(calib.right),
                   "rotation": np.asarray(calib.rotation).tolist(),
                   "translation": np.asarray(calib.translation).tolist()}, fh)
    with open(root / "config.json", "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh)
    paths.update(log=root / "log.csv", calib=root / "calib.json",
                 config=root / "config.json")
    return paths


def _count_syncs(fn):
    """(result, [file:line, ...]) of ``fn()`` under the sync debug mode
    "warn": one entry per operation that made the host wait for the card."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # each wait warns "called a synchronizing CUDA operation"; the mode's own
    # notice that it is a prototype is no wait
    where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    return result, where


def phase_apps(device, frames, data, cfg, ate_main: float) -> None:
    """The user's entry points: the reconstruct CLI on a disk folder of the
    bench frames (uninterrupted, cut and resumed from a checkpoint, offline
    on the exact disparity, with the pyramid, with the profiler), the depth
    and BA-solve tools, the host syncs of a steady frame with and without
    the prefetcher, its host calls, and a snapshot's size and write time.
    ``ate_main`` is the main path's ATE at the same configuration."""
    import contextlib
    import io

    import torch

    from online_3d_reconstruction_tpu_torch.apps import ba_solve, depth
    from online_3d_reconstruction_tpu_torch.apps import reconstruct as cli
    from online_3d_reconstruction_tpu_torch.io import ImageFolderSequence
    from online_3d_reconstruction_tpu_torch.io.export import load_ply, load_trajectory_tum
    from online_3d_reconstruction_tpu_torch.mapping.global_map import GlobalMap
    from online_3d_reconstruction_tpu_torch.runtime.checkpoint import save_checkpoint
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import OnlineReconstructor
    from online_3d_reconstruction_tpu_torch.runtime.prefetch import device_prefetch
    from online_3d_reconstruction_tpu_torch.utils import cuda_build
    from online_3d_reconstruction_tpu_torch.utils.metrics import ate_rmse

    n = len(frames)
    gt = np.stack([f.gt_pose for f in frames])
    priors = np.stack([f.prior_pose for f in frames])
    ate_prior = ate_rmse(priors, gt)
    root = ROOT / "build" / "apps_smoke"
    t0 = time.perf_counter()
    paths = write_disk_folder(root, frames, data.calib, cfg)
    folder = ImageFolderSequence(left_dir=str(paths["left"]), right_dir=str(paths["right"]),
                                 flight_log=str(paths["log"]))
    read_priors = np.stack([f.prior_pose for f in folder])
    prior_err = float(np.abs(read_priors - priors).max())
    log("apps disk folder", frames=len(folder), host_s=time.perf_counter() - t0,
        prior_readback_max_abs_err=prior_err)
    if len(folder) != n or prior_err > 1e-5:
        raise AssertionError(f"flight-log priors read back off by {prior_err}")

    base = ["--left", str(paths["left"]), "--right", str(paths["right"]),
            "--flight-log", str(paths["log"]), "--calib", str(paths["calib"]),
            "--config", str(paths["config"]), "--device", str(device), "--quiet"]

    def run_cli(name, *extra):
        out = root / name
        cuda_build.reset_launch_counts()
        if cli.main(base + ["--output", str(out), *extra]) != 0:
            raise AssertionError(f"reconstruct CLI ({name}) exited non-zero")
        _, poses = load_trajectory_tum(str(out / "trajectory.tum"))
        return out, poses, dict(cuda_build.launch_counts)

    # uninterrupted
    out, full, launches = run_cli("full", "--pcd", "--viewer", "--metrics")
    ate = ate_rmse(full, gt)
    pts, _ = load_ply(str(out / "map.ply"))
    want = {name: n * k for name, k in LAUNCHES_PER_FRAME.items()}
    log("apps reconstruct", entry=f"apps.reconstruct.main(--device {device})", frames=len(full),
        launches=launches, map_points=len(pts), ate_m=ate, ate_prior_only_m=ate_prior,
        ate_over_prior=ate / ate_prior,
        outputs=sorted(p.name for p in out.iterdir()))
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"CLI launches {launches}, expected {want}")
    if not (full.shape == (n, 4, 4) and np.isfinite(full).all() and len(pts) > 1000
            and np.isfinite(pts).all() and ate <= 0.5 * ate_prior):
        raise AssertionError(f"CLI run: ATE {ate} m vs prior-only {ate_prior} m, "
                             f"{len(pts)} map points")

    # the app adds nothing of its own: the library on the frames the folder
    # reader gives equals the CLI's trajectory; what separates the CLI's ATE
    # from the main path's is the folder's left image (the mean of the tinted
    # RGB it stores, not the rendered gray) and, far less, the priors' trip
    # through the quaternion log
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import reconstruct

    twin = reconstruct(list(folder), cfg, data.rig, device=device).trajectory
    mean_gray = [f._replace(left=f.color.mean(axis=-1).astype(np.float32)) for f in frames]
    gray = reconstruct(mean_gray, cfg, data.rig, device=device).trajectory
    gaps = {name: float(np.abs(t[:, :3, 3] - full[:, :3, 3]).max())
            for name, t in (("library_on_folder_frames", twin),
                            ("rendered_frames_left_as_rgb_mean", gray))}
    log("apps cli vs library", max_dt_to_cli_m=gaps, ate_cli_m=ate,
        ate_library_on_folder_frames_m=ate_rmse(twin, gt),
        ate_rendered_left_as_rgb_mean_m=ate_rmse(gray, gt), ate_main_path_m=ate_main)
    if not gaps["library_on_folder_frames"] <= 1e-5:
        raise AssertionError(f"the CLI's trajectory is not the library's: {gaps}")

    # cut after half the frames (snapshots every 4th keyframe), then resumed
    _, cut, _ = run_cli("resume", "--checkpoint-every", "4", "--last", str(n // 2 - 1))
    out, resumed, _ = run_cli("resume", "--checkpoint-every", "4", "--resume")
    rpts, _ = load_ply(str(out / "map.ply"))
    dt = float(np.abs(resumed[:, :3, 3] - full[:, :3, 3]).max())
    dr = float(rotation_angle(resumed, full).max())
    log("apps resume", cut_frames=len(cut), frames=len(resumed), max_dt_m=dt,
        max_dr_rad=dr, map_points=[len(rpts), len(pts)],
        snapshot_bytes=(out / "checkpoints" / "snapshot.npz").stat().st_size)
    if not (len(cut) == n // 2 and resumed.shape == full.shape and dt <= 1e-4 and dr <= 1e-4
            and abs(len(rpts) - len(pts)) <= 0.005 * len(pts)):
        raise AssertionError("the resumed run differs from the uninterrupted one")

    # offline mode on the scene's exact disparity: no SGM kernel runs
    out, offline, launches = run_cli("offline", "--disparity-dir", str(paths["disp"]))
    ate_off = ate_rmse(offline, gt)
    opts, _ = load_ply(str(out / "map.ply"))

    def on_surface(points):
        """Share of map points within two voxels of the ground or the plateau top."""
        z = points[:, 2]
        return float(((np.abs(z) < 0.5) | (np.abs(z - PLATEAU_HEIGHT) < 0.5)).mean())

    log("apps offline", frames=len(offline), launches=launches, ate_m=ate_off,
        map_points=len(opts), online_map_points=len(pts), on_surface=on_surface(opts),
        online_on_surface=on_surface(pts))
    if any(stereo_launches(launches).values()) or not (offline.shape == (n, 4, 4)
                                                       and np.isfinite(ate_off)):
        raise AssertionError(f"offline run: launches {launches}, ATE {ate_off}")
    if not (abs(len(opts) - PORT_OFFLINE_MAP_POINTS) <= 0.02 * PORT_OFFLINE_MAP_POINTS
            and on_surface(opts) > 0.99 and on_surface(pts) < 0.9):
        raise AssertionError(f"offline map: {len(opts)} points, {on_surface(opts)} of them on "
                             f"a surface (online {on_surface(pts)})")

    # the image pyramid, and the program's trace (the steady frames replayed
    # from graphs that hold the stages' device stamps)
    _, pyr, _ = run_cli("pyramid", "--set", "features.num_levels=3", "--last",
                              str(N_WARMUP - 1))
    log("apps pyramid", frames=len(pyr), levels=3, ate_m=ate_rmse(pyr, gt[:N_WARMUP]))
    if not (pyr.shape == (N_WARMUP, 4, 4) and np.isfinite(pyr).all()):
        raise AssertionError("the pyramid run gave no finite trajectory")
    out, _, _ = run_cli("profile", "--set", "runtime.profile=true", "--last", "3")
    trace = out / "checkpoints" / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"] if trace.exists() else []
    process = sorted(e["args"]["frame"] for e in events
                     if e.get("name") == "process" and e.get("ph") == "X")
    stages = {e["name"] for e in events if e.get("cat") == "stage"}
    replays = sum(1 for e in events if e.get("name") == "step.replay")
    log("apps profile", frames=4, trace_bytes=trace.stat().st_size if trace.exists() else 0,
        process_spans=len(process), stages=len(stages), replays=replays)
    if not (process == [0, 1, 2, 3] and {"disparity.cost", "disparity.aggregate", "tracking",
                                         "ba"} <= stages and replays >= 1):
        raise AssertionError(f"the program's trace at {trace}: frames {process}, stages "
                             f"{sorted(stages)}, {replays} replays")

    # the depth tool on frame 12, against the scene's exact disparity
    stamp = f"{frames[N_WARMUP].timestamp:.6f}.npy"
    out = root / "depth"
    if depth.main(["--left", str(paths["left"] / stamp), "--right", str(paths["right"] / stamp),
                   "--calib", str(paths["calib"]), "--output", str(out), "--device", str(device),
                   "--set", f"stereo.num_paths={cfg.stereo.num_paths}",
                   "--set", f"stereo.max_disparity={cfg.stereo.max_disparity}"]) != 0:
        raise AssertionError("depth tool exited non-zero")
    disp, gt_d = np.load(out / "disparity.npy"), frames[N_WARMUP].disparity
    ok = (disp >= 0) & (gt_d > 0)
    density, bad1 = float(ok.mean()), float((np.abs(disp[ok] - gt_d[ok]) > 1.0).mean())
    log("apps depth", frame=N_WARMUP, density=density, bad_1px=bad1)
    if not (density > 0.9 and bad1 < 0.02):
        raise AssertionError(f"depth tool below the bars: {density}, {bad1}")

    # the BA-solve tool's self-test: the cost must fall
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ba_solve.main(["--selftest", "--device", str(device)])
    ba = json.loads(buf.getvalue().strip().splitlines()[-1])
    log("apps ba_solve", **ba)
    if not ba["cost_trace"][-1] < ba["cost_trace"][0]:
        raise AssertionError(f"BA self-test cost did not fall: {ba['cost_trace']}")

    # host syncs of one steady keyframe frame on the graph step, without and
    # with the prefetcher; with the prefetcher the whole frame runs under the
    # sync debug mode "error" (any wait for the card raises)
    def prefetched(eng, i):
        stream = device_prefetch([frames[i]], eng, depth=2)
        torch.cuda.set_sync_debug_mode("error")   # the upload must not wait for the card
        try:
            frame, packed = next(iter(stream))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eng.synchronize()
        return stream, frame, packed

    engine = OnlineReconstructor(cfg, data.rig, device)
    for f in frames[:N_WARMUP]:
        engine.process(f)
    engine.synchronize()
    _, plain_syncs = _count_syncs(lambda: engine.process(frames[N_WARMUP]))
    stream, frame, packed = prefetched(engine, N_WARMUP + 1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = engine.process(frame, packed=packed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    stream.close()
    log("host syncs", frame=N_WARMUP + 1, keyframe=rec["keyframe"], step="graph",
        without_prefetch=len(plain_syncs), with_prefetch=0, upload_syncs=0,
        sites_without_prefetch=plain_syncs)
    if not plain_syncs:
        raise AssertionError("no sync counted without the prefetcher: the count is blind")

    # the host's calls into the CUDA runtime in the next steady keyframe
    # frame (torch.profiler's runtime events by name; the benchmark counts
    # its launches and device operations)
    stream, frame, packed = prefetched(engine, N_WARMUP + 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        engine.process(frame, packed=packed)
        engine.synchronize()
    stream.close()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith(("cuda", "cu")) and "Synchronize" not in e.key}
    log("host launches", frame=N_WARMUP + 2, runtime_calls=calls)
    # where the profiler saw the runtime at all, the step must be one graph
    if calls and calls.get("cudaGraphLaunch", 0) != 1:
        raise AssertionError(f"the steady frame was not one graph launch: {calls}")
    for f in frames[N_WARMUP + 3:]:
        engine.process(f)
    engine.synchronize()

    # snapshots of the engine (all frames in, the 2M-point pools), then
    # of the same engine with its main pool filled to capacity by shifted
    # copies of the live map (the size a long flight reaches)
    def timed_snapshot(name):
        snap = root / name / "snapshot.npz"
        start = time.perf_counter()
        save_checkpoint(engine, str(snap))
        return snap.stat().st_size, time.perf_counter() - start

    size, write_s = timed_snapshot("snapshot_timing")
    live, cap = int(engine.gmap.cursor), cfg.mapping.map_capacity
    slot = torch.arange(cap, device=device)
    shift = (slot // live).to(torch.float32)[:, None] * torch.tensor([40.0, 0.0, 0.0],
                                                                      device=device)
    engine.gmap = GlobalMap(points=engine.gmap.points[slot % live] + shift,
                            colors=engine.gmap.colors[slot % live],
                            valid=engine.gmap.valid[slot % live],
                            cursor=torch.tensor(cap, device=device))
    full_size, full_write_s = timed_snapshot("snapshot_full_pool")
    log("checkpoint", map_capacity=cap, map_points=live,
        staged_points=int(engine._staging.cursor), keyframes=len(engine.keyframes),
        bytes=size, write_s=write_s, full_pool_points=int(engine.gmap.valid.sum()),
        full_pool_bytes=full_size, full_pool_write_s=full_write_s)


def phase_profiler(device) -> dict:
    """The per-stage profiler at its full size, with the kernel counters
    read around it; every row of the reference tool must be there."""
    from online_3d_reconstruction_tpu_torch.tools import profile_stages
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    cuda_build.reset_launch_counts()
    rows = profile_stages.main(384, 512, 64, device=device)
    launches = dict(cuda_build.launch_counts)
    want = re.findall(r'bench\(\s*"([^"]+)"',
                      (ROOT / "tools" / "profile_stages.py").read_text())
    want.append(profile_stages.TOTAL)
    names = [name for name, _ in rows if not name.endswith(profile_stages.PORT_ONLY)]
    if (names != want or len(rows) != len(want) + 2
            or not all(np.isfinite(ms) and ms > 0 for _, ms in rows)):
        raise AssertionError(f"profiler rows {rows} do not match the reference's {want} "
                             "and the port's plain census chain and bf16 aggregation rows")
    if not (launches["scan_pair"] > 0 and launches["scan_fwd"] == launches["scan_bwd"] == 0):
        raise AssertionError(f"the profiler's scan_pair row is not one K3 launch a "
                             f"call: {launches}")
    log("profiler", entry="tools.profile_stages.main(384, 512, 64)",
        stage_ms=dict(rows), launches=launches)
    return launches


def phase_profile_sgm(device) -> dict:
    """The aggregation profiler at its full size (the path of the skewed
    volumes and of each K3 pass alone), with the kernel counters read around
    it; every scan row of the reference tool must be there, per dtype."""
    from online_3d_reconstruction_tpu_torch.tools import profile_sgm
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    cuda_build.reset_launch_counts()
    rows = profile_sgm.main(384, 512, 64, device=device)
    launches = dict(cuda_build.launch_counts)
    reference = (ROOT / "tools" / "profile_sgm.py").read_text()
    want = [f"[{tag}] {row}" for tag, _ in profile_sgm.DTYPES
            for row in profile_sgm.SCAN_ROWS if row in reference]
    names = [name for name, _ in rows]
    if (len(want) != 8 or not set(want) <= set(names)
            or not all(np.isfinite(ms) and ms > 0 for _, ms in rows)):
        raise AssertionError(f"profile_sgm rows {rows} lack some of the reference's {want}")
    if not all(launches[k] > 0 for k in ("scan_pair", "scan_fwd", "scan_bwd", "sgm_path")):
        raise AssertionError(f"profile_sgm did not launch every K3 kernel and K1: {launches}")
    log("profile_sgm", entry="tools.profile_sgm.main(384, 512, 64)", row_ms=dict(rows),
        launches=launches)
    return launches


def phase_small_agreement(device) -> None:
    """The same 6 frames of a 256x192 distorted rig through reconstruct on
    the card and on the CPU (plain versions), window BA off and on:
    keyframes equal, poses within 1e-3 m and 1e-3 rad, map sizes within
    0.5%."""
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import reconstruct

    rig, data = make_sequence(192, 256, 200.0, 6, 15.0, 0.6)
    frames = render_frames(data)
    for ba in (False, True):
        cfg = make_config(192, 256, 32, 256, 200_000, ba=ba)
        res = {dev: reconstruct(frames, cfg, rig, device=dev) for dev in (device, "cpu")}
        a, b = res[device], res["cpu"]
        dt = float(np.abs(a.trajectory[:, :3, 3] - b.trajectory[:, :3, 3]).max())
        dr = float(rotation_angle(a.trajectory, b.trajectory).max())
        na, nb = len(a.map_points), len(b.map_points)
        same_kf = bool(np.array_equal(a.keyframe_indices, b.keyframe_indices))
        log("cuda vs cpu", window_ba=ba, frames=len(frames), max_dt_m=dt, max_dr_rad=dr,
            map_points=[na, nb], keyframes_equal=same_kf)
        if not (dt < 1e-3 and dr < 1e-3 and abs(na - nb) <= 0.005 * nb and same_kf):
            raise AssertionError("the card's run disagrees with the CPU's on the "
                                 f"small input (window BA {ba})")


def _within(got, want, rtol=1e-4, atol=1e-5) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 means within tolerance."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def phase_distributed(device, frames, data, cfg, single) -> None:
    """The multi-rank paths at world size 1 on the card (there is one): item
    10 of the module docstring. ``single`` is the main path's result."""
    import tempfile

    import torch
    import torch.distributed as dist

    from online_3d_reconstruction_tpu_torch.parallel import mesh as pmesh
    from online_3d_reconstruction_tpu_torch.runtime.distributed import initialize

    with tempfile.TemporaryDirectory(prefix="o3r_smoke_") as tmp:
        initialize(f"file://{tmp}/store", 1, 0)
        try:
            mesh = pmesh.make_mesh()
            # make_mesh leaves a mesh of one rank without a group (its
            # collectives are the identity); with the group forced every
            # collective goes through nccl, and must still be the identity
            forced = pmesh.Mesh(mesh.axis_names, 1, 0, dist.group.WORLD, mesh.device)
            x = torch.arange(24, dtype=torch.float32, device=device).reshape(4, 6)
            checks = dict(
                psum=torch.equal(pmesh.psum(x, forced), x),
                psum_int64=int(pmesh.psum(torch.tensor(7, device=device), forced)) == 7,
                all_gather=torch.equal(pmesh.all_gather(x, forced), x),
                all_gather_bool=torch.equal(pmesh.all_gather(x > 5, forced), x > 5),
                all_to_all=torch.equal(pmesh.all_to_all(x.to(torch.int32), forced),
                                       x.to(torch.int32)),
                shift_is_zeros=not bool(pmesh.shift(x, forced, 1).any()))
            log("distributed", backend=dist.get_backend(), world=dist.get_world_size(),
                mesh=dict(size=mesh.size, rank=mesh.rank, device=str(mesh.device),
                          has_group=mesh.group is not None), nccl_collectives=checks)
            if not (dist.get_backend() == "nccl" and all(checks.values())
                    and mesh.size == 1 and mesh.device.type == "cuda"):
                raise AssertionError(f"process group, mesh {mesh} or collectives {checks}")
            _distributed_paths(device, frames, data, cfg, single, mesh)
        finally:
            dist.destroy_process_group()


def _distributed_paths(device, frames, data, cfg, single, mesh) -> None:
    import torch

    from online_3d_reconstruction_tpu_torch.ba.schur import solve_ba
    from online_3d_reconstruction_tpu_torch.ba.testing import make_synthetic_bundle
    from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
    from online_3d_reconstruction_tpu_torch.mapping.voxel import voxel_downsample
    from online_3d_reconstruction_tpu_torch.parallel.ba_sharded import (
        solve_ba_sharded, solve_ba_slot_sharded)
    from online_3d_reconstruction_tpu_torch.parallel.sgm_sharded import sharded_disparity
    from online_3d_reconstruction_tpu_torch.parallel.voxel_sharded import (
        sharded_voxel_downsample, voxel_route_merge)
    from online_3d_reconstruction_tpu_torch.runtime.distributed import reconstruct_distributed
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import OnlineReconstructor
    from online_3d_reconstruction_tpu_torch.stereo import sgm, sgm_cuda
    from online_3d_reconstruction_tpu_torch.stereo.rectify import rectify_pair
    from online_3d_reconstruction_tpu_torch.tools import scaling_bench
    from online_3d_reconstruction_tpu_torch.utils import cuda_build
    from online_3d_reconstruction_tpu_torch.utils.metrics import ate_rmse

    st, halo, n = cfg.stereo, 32, len(frames)
    # K1 at the row-slab shapes: slab + 2 * halo rows at mesh sizes 1 and 4
    gen = torch.Generator().manual_seed(6)
    slabs = (st.height + 2 * halo, st.height // 4 + 2 * halo)
    for rows in slabs:
        cost = torch.randint(0, 33, (rows, st.width, st.max_disparity), generator=gen,
                             dtype=torch.uint8).to(device)
        for form in (torch.float32, torch.bfloat16, torch.float16):
            if not torch.equal(sgm_cuda.aggregate(cost, st.p1, st.p2, st.num_paths, form),
                               sgm_cuda.aggregate_plain(cost, st.p1, st.p2, st.num_paths,
                                                        form)):
                raise AssertionError(f"K1 {form} differs from its plain version at "
                                     f"{tuple(cost.shape)}")
    log("distributed K1 slab shapes", paths=st.num_paths,
        shapes=[[rows, st.width, st.max_disparity] for rows in slabs],
        dtypes=["float32", "bfloat16", "float16"], equal=True)

    # one bench frame: the row-slab form (zero halos at size 1) against the
    # monolithic one, with the reference test's measures
    f0 = frames[N_WARMUP]
    left_r, right_r = rectify_pair(
        torch.as_tensor(f0.left, device=device), torch.as_tensor(f0.right, device=device),
        torch.as_tensor(data.rig.map_left, device=device),
        torch.as_tensor(data.rig.map_right, device=device))
    d_ref, v_ref = sgm.sgm_disparity(left_r, right_r, st)
    d_sh, v_sh = sharded_disparity(left_r, right_r, st, mesh, halo=halo)
    both = v_ref & v_sh
    diff = (d_ref - d_sh).abs()[both]
    exact, close = float((diff < 0.01).float().mean()), float((diff <= 1.0).float().mean())
    log("distributed sharded_disparity", frame=N_WARMUP, halo=halo,
        both_valid=float(both.float().mean()), exact=exact, within_1px=close,
        valid_single=float(v_ref.float().mean()), valid_sharded=float(v_sh.float().mean()))
    if not (float(both.float().mean()) > 0.5 and close > 0.995):
        raise AssertionError(f"sharded disparity: within 1 px on {close} of the pixels")

    # the loop, with the launch counters read around it
    gt = np.stack([f.gt_pose for f in frames])
    ate_prior = ate_rmse(np.stack([f.prior_pose for f in frames]), gt)
    cuda_build.reset_launch_counts()
    result = reconstruct_distributed(frames, cfg, data.rig, mesh, sgm_halo=halo,
                                     device=device)
    launches = dict(cuda_build.launch_counts)
    ate = ate_rmse(result.trajectory, gt)
    dt = float(np.abs(result.trajectory[:, :3, 3] - single.trajectory[:, :3, 3]).max())
    same_kf = bool(np.array_equal(result.keyframe_indices, single.keyframe_indices))
    log("distributed main path", entry="reconstruct_distributed(mesh of 1, device='cuda')",
        frames=n, launches=launches, keyframes=len(result.keyframe_indices),
        keyframes_equal=same_kf, map_points=[len(result.map_points), len(single.map_points)],
        ate_m=ate, ate_single_m=ate_rmse(single.trajectory, gt), ate_prior_only_m=ate_prior,
        ate_over_prior=ate / ate_prior, max_dt_to_single_m=dt)
    for name, k in LAUNCHES_PER_FRAME.items():
        if launches[name] != n * k:
            raise AssertionError(f"{name}: {launches[name]} launches in the distributed "
                                 f"path, expected {n} frames x {k}")
    if not (same_kf and result.trajectory.shape == (n, 4, 4)
            and np.isfinite(result.map_points).all() and ate <= 0.5 * ate_prior):
        raise AssertionError(f"distributed run: ATE {ate} m against 0.5x prior-only "
                             f"{0.5 * ate_prior} m, keyframes equal {same_kf}")

    # the sharded solves at the reference bench's large window
    w, l, k, iters = 64, 2048, 512, 3
    problem, _, _ = make_synthetic_bundle(np.random.default_rng(3), w=w, l=l,
                                          obs_noise=0.02, n_cap=w * k, obs_per_kf=k,
                                          device=device)
    kw = dict(iters=iters, damping=1e-4, huber_delta=0.5)
    out = dict(
        solve_ba=solve_ba(problem, **kw),
        solve_ba_sharded=solve_ba_sharded(problem, mesh, **kw),
        solve_ba_slot_major=solve_ba(problem, slot_major=k, **kw),
        solve_ba_slot_sharded=solve_ba_slot_sharded(problem, mesh, slot_major=k, **kw))
    worst = {f"{a}_vs_{b}": max(_within(out[a][0], out[b][0]),
                                _within(out[a][2], out[b][2], atol=0.0))
             for a, b in (("solve_ba_sharded", "solve_ba"),
                          ("solve_ba_slot_sharded", "solve_ba_slot_major"))}
    log("distributed solves", window=w, landmarks=l, slot_major=k, gn_iters=iters,
        cost_trace=[float(c) for c in out["solve_ba_sharded"][2]],
        worst_error_over_tolerance=worst, rtol=1e-4, atol=1e-5)
    if not (max(worst.values()) <= 1.0
            and float(out["solve_ba_sharded"][2][-1]) < float(out["solve_ba_sharded"][2][0])):
        raise AssertionError(f"sharded solves against solve_ba: {worst}")

    # both sharded voxel forms on a full staging pool (7 frames staged)
    engine = OnlineReconstructor(cfg, data.rig, device)
    for f in frames[:cfg.mapping.downsample_every - 1]:
        engine.process(f)
    pool = engine._staging
    pts, cols, val = pool.points.clone(), pool.colors.clone(), pool.valid.clone()
    vs, bounds = cfg.mapping.voxel_size, cfg.mapping.bounds
    ref = voxel_downsample(PointCloud(pts, cols, val), vs, bounds)
    merged, dropped = voxel_route_merge(pts, cols, val, mesh, vs, bounds)
    errs = {}
    for name, got in (("sharded_voxel_downsample",
                       sharded_voxel_downsample(pts, cols, val, mesh, vs, bounds)),
                      ("voxel_route_merge", merged)):
        if int(got.valid.sum()) != int(ref.valid.sum()):
            raise AssertionError(f"{name}: {int(got.valid.sum())} voxels, "
                                 f"{int(ref.valid.sum())} single-device")
        # both are compacted in key order: slot i is the same voxel
        m = int(ref.valid.sum())
        errs[name] = float((got.points[:m] - ref.points[:m]).abs().max())
    log("distributed voxel", pool_points=int(val.sum()), pool_capacity=int(val.numel()),
        voxels=int(ref.valid.sum()), dropped=int(dropped), max_centroid_err_m=errs)
    if not (int(dropped) == 0 and max(errs.values()) <= 1e-4):
        raise AssertionError(f"sharded voxel forms: dropped {int(dropped)}, errors {errs}")

    # several ranks exist only on the CPU here: every sharded stage on 1 and
    # 4 gloo processes, which must agree (another torch than the tests' box)
    t0 = time.perf_counter()
    wall_cpu = scaling_bench.wall_clock(scaling_bench.SMALL, (1, 4), timeout=300.0)
    d = wall_cpu["digests"]
    agree = dict(
        ba=bool(np.allclose(d["ba"][4], d["ba"][1], rtol=1e-4)),
        slots=bool(np.allclose(d["slots"][4], d["slots"][1], rtol=1e-4)),
        voxel=d["voxel"][4] == d["voxel"][1] and d["voxel"][1][1] == 0,
        sgm=abs(d["sgm"][4][0] - d["sgm"][1][0]) < 0.02)
    log("distributed cpu_gloo ranks", ranks=[1, 4], host_s=time.perf_counter() - t0,
        note="CPU processes over gloo at small shapes: agreement only, not a GPU time",
        agree=agree, cpu_seconds=wall_cpu["seconds"])
    if not all(agree.values()):
        raise AssertionError(f"1 and 4 CPU ranks disagree: {agree}, {d}")


# ---------------------------------------------------------------------------
# the lab phase: the estimator and solver tools on the identity-rig scene
# ---------------------------------------------------------------------------

def _tool(main, argv, device, **kw):
    """(result, printed lines, kernel launches) of one tool's ``main``."""
    import contextlib
    import io

    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    buf = io.StringIO()
    cuda_build.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        result = main(list(argv) + ["--device", str(device)], **kw)
    return result, buf.getvalue().splitlines(), dict(cuda_build.launch_counts)


def _table(lines, header: str, columns: int):
    """The float columns of the printed table under the line that starts
    with ``header``, up to the first blank line; every number finite."""
    start = next(i for i, line in enumerate(lines) if line.split()[:1] == [header])
    rows = []
    for line in lines[start + 1:]:
        if not line.strip():
            break
        numbers = [float(v) for v in re.findall(r"-?\d+\.\d+", line)]
        if len(numbers) != columns or not np.isfinite(numbers).all():
            raise AssertionError(f"table row does not parse: {line!r}")
        rows.append(numbers)
    if not rows:
        raise AssertionError(f"no rows under the {header!r} header")
    return np.asarray(rows)


def phase_lab(device, ate_main: float) -> None:
    """Item 11 of the module docstring (``ate_main``: the main path's ATE on
    the bench scene)."""
    import torch

    from online_3d_reconstruction_tpu_torch.stereo import sgm, sgm_cuda
    from online_3d_reconstruction_tpu_torch.tools import (
        ate_diag, ate_lab, ba_bias, ba_scale, bias_vs_edge, lab_scene, profile_ba64,
        profile_match, sgm_cache, vo_link_err)
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    n = 32
    t0 = time.perf_counter()
    frames = render_frames(lab_scene.make_sequence(n))                  # supersample 2
    t1 = time.perf_counter()
    aliased = render_frames(lab_scene.make_sequence(n, supersample=1))  # ate_diag, vo_link_err
    log("lab render", frames=n, resolution="512x384", rig="identity", workers=8,
        supersample_2_host_s=t1 - t0, supersample_1_host_s=time.perf_counter() - t1)
    cache = ROOT / "build" / "lab_smoke" / "sgm_cache.npz"
    if cache.exists():
        cache.unlink()
    want = {name: n * k for name, k in LAUNCHES_PER_FRAME.items()}

    # the direct sgm_disparity + detect_keypoints loop
    got, lines, launches = _tool(sgm_cache.main, ["--frames", str(n), "--out", str(cache)],
                                 device, frames=frames)
    stats = got["stats"]
    log("lab sgm_cache", frames=n, launches=launches, sgm_s=got["sgm_s"],
        bias_px=dict(min=float(stats[:, 0].min()), max=float(stats[:, 0].max()),
                     mean=float(stats[:, 0].mean())),
        rms_px=float(stats[:, 1].mean()), abs_err_px=float(stats[:, 2].mean()),
        keypoints_per_frame=float(stats[:, 3].mean()), summary=lines[-3:])
    if any(launches[k] != v for k, v in want.items()) or not np.isfinite(stats).all():
        raise AssertionError(f"sgm_cache launches {launches}, expected {want}")
    # frame 0 of the identity-rig, supersampled scene against sgm_disparity
    # with the plain versions in the kernels' place, on the card
    left = torch.as_tensor(frames[0].left, device=device)
    right = torch.as_tensor(frames[0].right, device=device)
    kernels = sgm.census_cost, sgm.aggregate, sgm.run_total
    sgm.census_cost, sgm.aggregate, sgm.run_total = (
        sgm_cuda.census_cost_plain, sgm_cuda.aggregate_plain, sgm_cuda.run_total_plain)
    try:
        cuda_build.reset_launch_counts()
        plain = sgm.sgm_disparity(left, right, sgm_cache.stereo_config())[0].cpu().numpy()
        plain_launches = dict(cuda_build.launch_counts)
    finally:
        sgm.census_cost, sgm.aggregate, sgm.run_total = kernels
    equal = bool(np.array_equal(got["disparity"][0], plain))
    log("lab sgm_cache frame 0", equal_to_plain_versions=equal,
        plain_run_launches=plain_launches,
        valid_share=float((got["disparity"][0] > 0).mean()))
    if not equal or any(plain_launches.values()):
        raise AssertionError("the cached frame 0 differs from sgm_disparity on the "
                             f"plain versions (their run launched {plain_launches})")

    rows, _, _ = _tool(bias_vs_edge.main, [str(cache)], device, frames=frames)
    log("lab bias_vs_edge", frames=12,
        bins=[dict(px=[lo, min(hi, 999)], n=k, mean=mean, rms=rms)
              for lo, hi, k, mean, rms in rows])
    if len(rows) != 4 or not all(k > 0 and np.isfinite([mean, rms]).all()
                                 for _, _, k, mean, rms in rows):
        raise AssertionError(f"bias_vs_edge rows {rows}")

    # the estimator sweep: offline on the exact disparity and on the cached
    # SGM maps (no kernel runs), then with SGM in every frame
    bench, product = "w bench W8 L512", "w W24 L2048 d1.0"
    sweep = {}
    for mode, extra in (("exact", []), ("sgm_cache", ["--sgm-cache", str(cache)])):
        res, _, launches = _tool(ate_lab.main, ["--variants", bench, product] + extra,
                                 device, frames=frames)
        sweep[mode] = {k: v / res["prior"] for k, v in res["ate"].items()}
        if (any(stereo_launches(launches).values())
                or not np.isfinite(list(res["ate"].values())).all()):
            raise AssertionError(f"ate_lab ({mode}): launches {launches}, ATE {res['ate']}")
    res, _, launches = _tool(ate_lab.main, ["--sgm", "--variants", product], device,
                             frames=frames)
    ratio = res["ate"][product] / res["prior"]
    log("lab ate_lab", frames=n, prior_only_ate_m=res["prior"], ate_over_prior=sweep,
        sgm_every_frame=dict(variant=product, ate_m=res["ate"][product],
                             ate_over_prior=ratio, launches=launches),
        bench_scene_ate_over_prior=ate_main / REF_ATE_PRIOR)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"ate_lab --sgm launches {launches}, expected {want}")
    if not ratio <= 0.5:
        raise AssertionError(f"lab scene: ATE {ratio:.4f}x prior-only with SGM, above 0.5x "
                             f"(bench scene {ate_main / REF_ATE_PRIOR:.4f}x)")

    # the diagnosis tools, offline, at their own frame counts
    res, lines, _ = _tool(vo_link_err.main, [], device, frames=aliased)
    links = _table(lines, "lnk", 5)
    log("lab vo_link_err", links=len(links), link_rms_m=res["rms"],
        axis_rms_m=res["axis_rms"].tolist(), bias_m=res["bias"].tolist(),
        vo_used=int(sum(bool(u) for u in res["used_vo"])), summary=lines[-1])
    res, lines, _ = _tool(ba_bias.main, [], device, frames=frames)
    slots = _table(lines, "slot", 6)
    log("lab ba_bias", window_slots=len(slots), landmarks=res["landmarks"],
        observations=res["observations"], axis_rms_m=res["axis_rms"].tolist(),
        track_lengths=res["track_lengths"])
    res, lines, _ = _tool(ate_diag.main, [], device, frames=aliased)
    per_frame = _table(lines, "frm", 2)
    log("lab ate_diag", frames=len(per_frame), ate_full_m=res["ate_full"],
        ate_prior_m=res["ate_prior"], ate_oracle_m=res["ate_oracle"],
        rot_rms_deg=res["rot_rms_deg"], keyframes=int(sum(r[1] for r in res["rows"])),
        vo_used=int(sum(bool(r[2]) for r in res["rows"])),
        max_frame_err_m=float(per_frame[:, 0].max()))
    if not (len(links) == 23 and len(per_frame) == n and len(slots) >= 2):
        raise AssertionError("a lab table is short: "
                             f"{len(links)} links, {len(per_frame)} frames, {len(slots)} slots")

    # the solver profilers: CUDA-event times
    rows, lines, _ = _tool(profile_match.main, [], device)
    log("lab profile_match", us={name: sec * 1e6 for name, sec in rows}, printed=lines[1:])
    if len(rows) != 6 or not all(np.isfinite(sec) and sec > 0 for _, sec in rows):
        raise AssertionError(f"profile_match rows {rows}")
    rows, lines, _ = _tool(profile_ba64.main, [], device)
    ms = {name: sec * 1e3 for name, sec in rows}
    parts = sum(count * ms[name] for name, count in profile_ba64.STEP_PARTS)
    log("lab profile_ba64", ms=ms, step_parts_sum_ms=parts,
        parts_over_one_step=parts / ms[profile_ba64.ONE_STEP],
        solve_rows=[line for line in lines if "launches" in line])
    # the step waits for the device at its host syncs, so the host's launches
    # add to it in full, while the parts' launches queue behind device work:
    # a slower host stretches the step alone (0.58 on one host, 0.45 on a
    # slower one, same code): a factor 3, not 2
    if not (len(rows) == 15 and all(np.isfinite(v) and v > 0 for v in ms.values())
            and 1 / 3 <= parts / ms[profile_ba64.ONE_STEP] <= 3.0):
        raise AssertionError(f"profile_ba64: parts {parts} ms against one step "
                             f"{ms[profile_ba64.ONE_STEP]} ms; rows {ms}")
    res, _, _ = _tool(ba_scale.main, ["--w", "8", "24", "64", "100", "--json",
                                      str(cache.with_name("ba_scale.json"))], device)
    log("lab ba_scale", gn_iters=res["gn_iters"], rows=res["rows"])
    if len(res["rows"]) != 4 or not all(np.isfinite(r["solve_s"]) and r["solve_s"] > 0
                                        and r["mean_pose_err_m"] < 0.05 for r in res["rows"]):
        raise AssertionError(f"ba_scale rows {res['rows']}")


def main() -> None:
    device = phase_device()
    import torch

    phase_build()
    rows = phase_kernels(device)
    k1, k1_half, k2, k3_fwd, k3_bwd, k3_pair, k4, k5, k6 = rows
    launches, launches_f32, frames, data, cfg, single, ate, ate_vo = phase_main_path(device)
    k7 = rigid_irls_row(device, frames, data.rig, cfg)
    rows.append(k7)
    phase_bench(device, frames, (single, ate), ate_vo, k1_half["ms"])
    phase_steady_profilers(device, frames)
    phase_apps(device, frames, data, cfg, ate)
    profiled = phase_profiler(device)
    sgm_profiled = phase_profile_sgm(device)
    phase_small_agreement(device)
    phase_distributed(device, frames, data, cfg, single)
    phase_lab(device, ate)

    # the main path at the default configuration runs K4, K1's half form
    # (bf16) and K2; its run at cost_dtype="float32" runs K1's f32 form (the
    # K1 launches that were not the half form's)
    for row, count in ((k1, launches_f32["sgm_path"] - launches_f32["sgm_path_half"]),
                       (k1_half, launches["sgm_path_half"]), (k2, launches["run_total"]),
                       (k4, launches["census_cost"])):
        row["launches"] = count
        row["launches_per_frame"] = count / len(frames)
    # K5: the default main-path run's reductions (its flushes, its
    # downsamples, and finish's flush and downsample)
    k5["launches"] = launches["voxel_reduce"]
    # K6, K7: the default main-path run's tracked frames (all but the first)
    for row, name in ((k6, "ransac_draw"), (k7, "rigid_irls")):
        row["launches"] = launches[name]
        row["launches_per_frame"] = launches[name] / len(frames)
    # K3 is on no frame's path: its launches are those of the profilers' runs
    k3_fwd["launches"] = sgm_profiled["scan_fwd"]
    k3_bwd["launches"] = sgm_profiled["scan_bwd"]
    k3_pair["launches"] = profiled["scan_pair"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
