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
     larger); K1 with fractional penalties twice (equal between the runs,
     within 1e-3 relative of the plain version);
  4. main path: ``reconstruct(..., device="cuda")`` on the benchmark scene
     and its full-stack configuration (512x384, D=64, 8-path SGM, distorted
     rig, window BA W=24/L=2048/3 GN iterations with the stereo noise model),
     32 frames; kernel launch counts from that run (K1 2 and K2 4 per
     frame), ATE against ground truth (the kernels are bit-equal, so it must
     repeat 0.11036939 m) beside prior-only ATE (full stack must reach <=
     0.5x), the BA-off
     VO-only ablation, the library's default configuration on the first
     12 frames, disparity quality on one frame, a steady frame rate and a
     per-stage device-time breakdown with the keyframe BA event;
  5. apps: the user's entry points on a disk folder of the same 32 frames
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
     of one steady keyframe frame with and without the prefetcher (the
     upload under the sync debug mode "error"), the steady frame rate with
     and without it in 6 alternating pairs, and a snapshot's size and write
     time at the 2M-point pool, as the run left it and filled to capacity;
  6. profiler: ``tools.profile_stages.main`` at 384x512x64, every row of the
     reference tool, with K3's launch counts from that run;
  7. agreement of the CUDA and CPU runs on a small input, BA off and on.
Then one JSON line with the kernels, and as the last line
{"ok": true, "device": {...}}. Any failure raises: exit code non-zero.
Uses only the port (no JAX).
"""

from __future__ import annotations

import concurrent.futures
import json
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
# the port's own full-stack ATE on this scene, the same digits in every run
# since window BA went in: the kernels are bit-equal to their plain versions
# and the trajectory does not depend on the map's atomics
PORT_ATE_FULL, PORT_MAP_POINTS = 0.11036939, 408_279
# kernel launches of one steady frame with the default (integer) penalties:
# K1 = the all-directions aggregation + the widening of its 16-bit sums
LAUNCHES_PER_FRAME = {"sgm_path": 2, "run_total": 4}
# NVIDIA H100 SXM (data sheet): HBM3 bytes/s and f32 operations/s outside the
# tensor cores; a kernel's bound is the larger of bytes and operations over these
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


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
                ba: bool):
    """The benchmark's configuration: with ``ba`` its full stack (window BA
    with the measured estimator preset), else its VO-only ablation."""
    from online_3d_reconstruction_tpu_torch.config import (
        BAConfig, FeatureConfig, MappingConfig, OdometryConfig, PipelineConfig,
        RuntimeConfig, StereoConfig)

    return PipelineConfig(
        stereo=StereoConfig(height=h, width=w, max_disparity=d, num_paths=8),
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

    rows = []
    gen = torch.Generator().manual_seed(0)
    cost = torch.randint(0, 33, (384, 512, 64), generator=gen,
                         dtype=torch.uint8).to(device)
    for paths in (8, 4):
        got = sgm_cuda.aggregate(cost, 8.0, 32.0, paths)
        want = sgm_cuda.aggregate_plain(cost, 8.0, 32.0, paths)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K1 ({paths} paths) differs from its plain "
                                 f"version: max abs err {err}")
        if paths == 8:
            ms = cuda_ms(lambda: sgm_cuda.aggregate(cost, 8.0, 32.0, 8), 50)
            plain_ms = cuda_ms(lambda: sgm_cuda.aggregate_plain(cost, 8.0, 32.0, 8),
                               2, warmup=0)
            # per cell and direction: 4 fminf, 4 additions, and its share of
            # the min over D (2)
            k1 = dict(name="sgm_path_aggregation", route="cuda",
                      source="online_3d_reconstruction_tpu_torch/csrc/sgm_aggregate.cu",
                      replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:224",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      **bound([cost, got], 10.0 * paths * cost.numel()), library_ms=None)
        log("kernel K1", paths=paths, shape=[384, 512, 64], equal=True,
            max_abs_err=err)
    rows.append(k1)
    # ragged shapes: D not a multiple of 32 (padding lanes), D = 128 and 256
    # (4 and 8 per lane over the whole warp), D = 8 (16 lines a warp), H and
    # W not multiples of the block, diagonals longer than wide; 2 paths
    shapes = ((37, 45, 40), (33, 70, 128), (70, 33, 8), (21, 19, 256))
    for shape in shapes:
        small = torch.randint(0, 33, shape, generator=gen, dtype=torch.uint8).to(device)
        for paths in (8, 2):
            if not torch.equal(sgm_cuda.aggregate(small, 8.0, 32.0, paths),
                               sgm_cuda.aggregate_plain(small, 8.0, 32.0, paths)):
                raise AssertionError(f"K1 ({paths} paths) differs from its plain "
                                     f"version at {shape}")
    log("kernel K1", paths=[8, 2], shapes=[list(s) for s in shapes], equal=True)
    # penalties that are not integers: one launch per direction, in order;
    # the same bits in two runs, and within f32 rounding of the plain version
    # (1e-3 relative, stated; the plain version sums the directions in pairs)
    sgm_cuda.reset_launch_counts()
    first = sgm_cuda.aggregate(cost, 7.5, 30.5, 8)
    ordered_launches = sgm_cuda.launch_counts["sgm_path"]
    second = sgm_cuda.aggregate(cost, 7.5, 30.5, 8)
    want = sgm_cuda.aggregate_plain(cost, 7.5, 30.5, 8)
    rel = float(((first - want).abs() / want.abs().clamp(min=1.0)).max())
    log("kernel K1 fractional penalties", p1=7.5, p2=30.5, launches=ordered_launches,
        runs_equal=torch.equal(first, second), max_rel_err=rel,
        ms=cuda_ms(lambda: sgm_cuda.aggregate(cost, 7.5, 30.5, 8), 20))
    if not (torch.equal(first, second) and rel <= 1e-3 and ordered_launches == 8):
        raise AssertionError(f"K1 with fractional penalties: runs equal "
                             f"{torch.equal(first, second)}, max rel err {rel}, "
                             f"{ordered_launches} launches")

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
    log("kernel times", note="K1: one 8-path aggregation (2 launches); "
        "K2: the 4 run totals of one speckle filter (4 launches, host clock "
        "between them included); K3 fwd, bwd: one pass each over the "
        "profiler's 384x512x64 f32 vertical pair",
        **{f"{k}_{f}": r[f] for k, r in zip(("K1", "K2", "K3fwd", "K3bwd"), rows)
           for f in ("ms", "plain_ms", "bound_ms")})
    return rows


def _scan_pair_rows(device, gen):
    """K3 (fwd, bwd) against its plain passes: bit-equal on integer costs
    0..32 in f32 and bf16 at the profiler's vertical pair, its transposed
    horizontal pair and ragged shapes (D not a multiple of 32, D = 128,
    lines fewer than a warp's block)."""
    import torch

    from online_3d_reconstruction_tpu_torch.stereo import sgm_cuda

    shapes = ((384, 512, 64), (512, 384, 64), (37, 45, 40), (33, 70, 128), (5, 3, 8))
    err_fwd = err_pair = 0.0
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            cost = torch.randint(0, 33, shape, generator=gen).to(dtype).to(device)
            fwd = torch.empty_like(cost)
            sgm_cuda.scan_launch("scan_fwd", cost, fwd, 8.0, 32.0)
            fwd_plain = sgm_cuda.scan_fwd_plain(cost, 8.0, 32.0)
            pair = sgm_cuda.scan_pair(cost, 8.0, 32.0)
            pair_plain = sgm_cuda.scan_bwd_plain(cost, fwd_plain.clone(), 8.0, 32.0)
            torch.cuda.synchronize()
            err_fwd = max(err_fwd, float((fwd.float() - fwd_plain.float()).abs().max()))
            err_pair = max(err_pair, float((pair.float() - pair_plain.float()).abs().max()))
            if not (torch.equal(fwd, fwd_plain) and torch.equal(pair, pair_plain)):
                raise AssertionError(f"K3 differs from its plain version at {shape} "
                                     f"{dtype}: fwd {err_fwd}, pair {err_pair}")
    log("kernel K3", shapes=[list(x) for x in shapes], dtypes=["float32", "bfloat16"],
        fwd_equal=True, pair_equal=True, max_abs_err_fwd=err_fwd,
        max_abs_err_pair=err_pair)

    cost = torch.randint(0, 24, (384, 512, 64), generator=gen).float().to(device)
    out = sgm_cuda.scan_fwd_plain(cost, 8.0, 32.0)
    ms_fwd = cuda_ms(lambda: sgm_cuda.scan_launch("scan_fwd", cost, out, 8.0, 32.0), 50)
    ms_bwd = cuda_ms(lambda: sgm_cuda.scan_launch("scan_bwd", cost, out, 8.0, 32.0), 50)
    plain_fwd = cuda_ms(lambda: sgm_cuda.scan_fwd_plain(cost, 8.0, 32.0), 2, warmup=1)
    plain_bwd = cuda_ms(lambda: sgm_cuda.scan_bwd_plain(cost, out, 8.0, 32.0), 2,
                        warmup=1)
    horizontal = cost.transpose(0, 1).contiguous()
    log("kernel K3 times", vertical_pair_ms=cuda_ms(
        lambda: sgm_cuda.scan_pair(cost, 8.0, 32.0), 50),
        horizontal_pair_ms=cuda_ms(lambda: sgm_cuda.scan_pair(horizontal, 8.0, 32.0), 50))
    source = "online_3d_reconstruction_tpu_torch/csrc/sgm_scan_pair.cu"
    # fwd reads the cost and writes the result; bwd reads both and writes;
    # per cell 4 fminf, 4 additions and its share of the min over D (2)
    return [dict(name="sgm_scan_fwd", route="cuda", source=source,
                 replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:63",
                 max_abs_err=err_fwd, ms=ms_fwd, plain_ms=plain_fwd,
                 **bound([cost, out], 10.0 * cost.numel()), library_ms=None),
            dict(name="sgm_scan_bwd", route="cuda", source=source,
                 replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:79",
                 max_abs_err=err_pair, ms=ms_bwd, plain_ms=plain_bwd,
                 **bound([cost, out, out], 11.0 * cost.numel()), library_ms=None)]


def stage_breakdown(engine, frames) -> dict:
    """Device ms per stage of a steady frame, by CUDA events around the
    same calls ``OnlineReconstructor._steady_step`` makes, over ``frames``;
    ``ba_event`` is the keyframe event (append + window solve) on the
    engine's window, run for every frame as if it were a keyframe."""
    import torch

    from online_3d_reconstruction_tpu_torch.ba.device_tracks import keyframe_core
    from online_3d_reconstruction_tpu_torch.geometry import se3
    from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
    from online_3d_reconstruction_tpu_torch.mapping.global_map import (
        create_map, flush_staging, insert_cloud)
    from online_3d_reconstruction_tpu_torch.odometry.frontend import (
        extract_frame_features, tracking_step)
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import unpack_frame
    from online_3d_reconstruction_tpu_torch.stereo import census, sgm, sgm_cuda
    from online_3d_reconstruction_tpu_torch.stereo.rectify import (
        rectify_pair, remap_bilinear)

    cfg, dev = engine.cfg, engine.device
    st = cfg.stereo
    kf = engine.keyframes[-1]
    staging = create_map(engine._staging_cap, dev)
    main = create_map(cfg.mapping.map_capacity, dev)
    totals: dict = {}
    for i, frame in enumerate(frames):
        packed = engine.pack(frame, frame_index=engine.frame_idx + i)
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        p = torch.from_numpy(packed).to(dev)
        prior, left, right, color, _ = unpack_frame(p, st.height, st.width, engine._cc)
        mark("upload_unpack")
        left_r, right_r = rectify_pair(left, right, engine.map_left, engine.map_right)
        color_r = remap_bilinear(color, engine._color_map)
        mark("rectify")
        cost = census.cost_volume(census.census_transform(left_r, st.census_window),
                                  census.census_transform(right_r, st.census_window),
                                  st.max_disparity).to(torch.uint8)
        mark("census_cost")
        agg = sgm_cuda.aggregate(cost, st.p1, st.p2, st.num_paths)
        mark("sgm_aggregate_K1")
        disp, valid = sgm.wta_disparity(agg, st.uniqueness_ratio, st.subpixel,
                                        fit=st.subpixel_fit)
        valid = valid & sgm.lr_consistency_mask_volume(
            disp, sgm.right_disparity_from_aggregated(agg), st.max_disparity,
            st.lr_max_diff) & (disp > 0.0)
        mark("wta_lr")
        valid = sgm.speckle_filter(disp, valid, st.speckle_window, st.speckle_range)
        disp = torch.where(valid, disp, st.invalid_value)
        mark("speckle_K2")
        feats = extract_frame_features(left_r, disp, engine.q, cfg.features, cfg.odometry)
        mark("features")
        cloud = engine._cloud(disp, color_r, prestrided=True)
        mark("backproject")
        pose, _, _, matches = tracking_step(feats, kf.features, kf.pose,
                                            kf.prior_pose, prior, engine.frame_idx + i,
                                            cfg.matching, cfg.odometry)
        mark("tracking")
        _, refined, _ = keyframe_core(engine._ba_state, feats.points3d, feats.valid3d,
                                      matches.index, matches.valid, pose, prior, cfg.ba,
                                      noise_model=engine._noise_model)
        pose = refined[min(engine._ba_state.count + 1, cfg.ba.window) - 1]
        mark("ba_event")
        insert_cloud(staging, PointCloud(se3.transform_points(pose, cloud.points),
                                         cloud.colors, cloud.valid))
        mark("insert")
        flush_staging(main, staging, cfg.mapping.voxel_size, cfg.mapping.bounds)
        mark("flush_staging")
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            totals[name] = totals.get(name, 0.0) + a.elapsed_time(b)
    return {k: v / len(frames) for k, v in totals.items()}


def phase_main_path(device):
    import torch

    from online_3d_reconstruction_tpu_torch.config import PipelineConfig
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
        OnlineReconstructor, reconstruct)
    from online_3d_reconstruction_tpu_torch.stereo import sgm, sgm_cuda
    from online_3d_reconstruction_tpu_torch.stereo.rectify import rectify_pair
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

    # the user's entry point, with the launch counters read around it
    sgm_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    result = reconstruct(frames, cfg, rig, device=device)
    wall = time.perf_counter() - t0
    launches = dict(sgm_cuda.launch_counts)
    per_frame = LAUNCHES_PER_FRAME
    for name, k in per_frame.items():
        if launches[name] != n * k:
            raise AssertionError(f"{name}: {launches[name]} launches in the main "
                                 f"path, expected {n} frames x {k}")
    ate = ate_rmse(result.trajectory, gt)
    if not (np.isfinite(ate) and np.isfinite(result.trajectory).all()):
        raise AssertionError(f"non-finite trajectory / ATE {ate}")
    if result.trajectory.shape != (n, 4, 4) or not np.isfinite(result.map_points).all():
        raise AssertionError("trajectory or map has the wrong shape or non-finite points")
    log("main path", entry="reconstruct(device='cuda')", frames=n,
        resolution=f"{w}x{h}x{d}", paths=cfg.stereo.num_paths, rectify="distorted rig",
        window_ba=dict(window=cfg.ba.window, max_landmarks=cfg.ba.max_landmarks,
                       gn_iters=cfg.ba.gn_iters),
        wall_s=wall, frames_per_s_incl_first=result.metrics.get("frames_per_s"),
        keyframes=len(result.keyframe_indices), map_points=int(len(result.map_points)),
        launches=launches, launches_per_frame=per_frame,
        ate_m=ate, ate_prior_only_m=ate_prior, ate_over_prior=ate / ate_prior,
        reference_ate_m=REF_ATE_FULL, reference_ate_over_prior=REF_ATE_FULL / REF_ATE_PRIOR,
        ate_aligned_m=ate_rmse(result.trajectory, gt, align=True))
    if not ate <= 0.5 * ate_prior:
        raise AssertionError(f"full-stack ATE {ate} m is above 0.5x prior-only "
                             f"({ate_prior} m)")
    # K1 and K2 are bit-equal to their plain versions, so the trajectory
    # cannot move: other digits mean a fault in a kernel, not noise
    if abs(ate - PORT_ATE_FULL) > 5e-8:
        raise AssertionError(f"full-stack ATE {ate:.8f} m differs from the port's "
                             f"{PORT_ATE_FULL:.8f} m")
    if abs(len(result.map_points) - PORT_MAP_POINTS) > 0.005 * PORT_MAP_POINTS:
        raise AssertionError(f"{len(result.map_points)} map points, expected "
                             f"{PORT_MAP_POINTS} within 0.5%")

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

    # steady frame rate (benchmark split) and the per-stage breakdown
    engine = OnlineReconstructor(cfg, rig, device)
    for f in frames[:N_WARMUP]:
        engine.process(f)
    engine.synchronize()
    t0 = time.perf_counter()
    for f in frames[N_WARMUP:]:
        engine.process(f)
    engine.synchronize()
    steady = time.perf_counter() - t0
    timed_kf = sum(1 for r in engine.metrics.records[N_WARMUP:] if r["keyframe"])
    stages = stage_breakdown(engine, frames[N_WARMUP:N_WARMUP + 8])
    log("steady", frames=N_TIMED, keyframes=timed_kf, frames_per_s=N_TIMED / steady,
        frame_ms=1e3 * steady / N_TIMED,
        stage_device_ms=stages, stage_sum_ms=sum(stages.values()),
        peak_mem_mb=torch.cuda.max_memory_allocated(device) / 2**20)
    return launches, frames, data, cfg


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
    where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return result, where


def phase_apps(device, frames, data, cfg) -> None:
    """The user's entry points: the reconstruct CLI on a disk folder of the
    bench frames (uninterrupted, cut and resumed from a checkpoint, offline
    on the exact disparity, with the pyramid, with the profiler), the depth
    and BA-solve tools, the host syncs of a steady frame with and without
    the prefetcher, and the steady frame rate with and without it."""
    import contextlib
    import dataclasses
    import io

    import torch

    from online_3d_reconstruction_tpu_torch.apps import ba_solve, depth
    from online_3d_reconstruction_tpu_torch.apps import reconstruct as cli
    from online_3d_reconstruction_tpu_torch.io import ImageFolderSequence
    from online_3d_reconstruction_tpu_torch.io.export import load_ply, load_trajectory_tum
    from online_3d_reconstruction_tpu_torch.mapping.global_map import GlobalMap
    from online_3d_reconstruction_tpu_torch.runtime.checkpoint import save_checkpoint
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
        OnlineReconstructor, run_frames)
    from online_3d_reconstruction_tpu_torch.runtime.prefetch import device_prefetch
    from online_3d_reconstruction_tpu_torch.stereo import sgm_cuda
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
        sgm_cuda.reset_launch_counts()
        start = time.perf_counter()
        if cli.main(base + ["--output", str(out), *extra]) != 0:
            raise AssertionError(f"reconstruct CLI ({name}) exited non-zero")
        wall = time.perf_counter() - start
        _, poses = load_trajectory_tum(str(out / "trajectory.tum"))
        with open(out / "summary.json") as fh:
            summary = json.load(fh)
        return out, poses, dict(sgm_cuda.launch_counts), wall, summary

    # uninterrupted
    out, full, launches, wall, summary = run_cli("full", "--pcd", "--viewer", "--metrics")
    ate = ate_rmse(full, gt)
    pts, _ = load_ply(str(out / "map.ply"))
    want = {name: n * k for name, k in LAUNCHES_PER_FRAME.items()}
    log("apps reconstruct", entry=f"apps.reconstruct.main(--device {device})", frames=len(full),
        wall_s=wall, frames_per_s_incl_first=summary.get("frames_per_s"),
        launches=launches, map_points=len(pts), ate_m=ate, ate_prior_only_m=ate_prior,
        ate_over_prior=ate / ate_prior,
        outputs=sorted(p.name for p in out.iterdir()))
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"CLI launches {launches}, expected {want}")
    if not (full.shape == (n, 4, 4) and np.isfinite(full).all() and len(pts) > 1000
            and np.isfinite(pts).all() and ate <= 0.5 * ate_prior):
        raise AssertionError(f"CLI run: ATE {ate} m vs prior-only {ate_prior} m, "
                             f"{len(pts)} map points")

    # cut after half the frames (snapshots every 4th keyframe), then resumed
    _, cut, _, _, _ = run_cli("resume", "--checkpoint-every", "4", "--last", str(n // 2 - 1))
    out, resumed, _, wall, _ = run_cli("resume", "--checkpoint-every", "4", "--resume")
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
    _, offline, launches, wall, _ = run_cli("offline", "--disparity-dir", str(paths["disp"]))
    ate_off = ate_rmse(offline, gt)
    log("apps offline", frames=len(offline), launches=launches, ate_m=ate_off, wall_s=wall)
    if any(launches.values()) or not (offline.shape == (n, 4, 4) and np.isfinite(ate_off)):
        raise AssertionError(f"offline run: launches {launches}, ATE {ate_off}")

    # the image pyramid, and the profiler trace
    _, pyr, _, _, _ = run_cli("pyramid", "--set", "features.num_levels=3", "--last",
                              str(N_WARMUP - 1))
    log("apps pyramid", frames=len(pyr), levels=3, ate_m=ate_rmse(pyr, gt[:N_WARMUP]))
    if not (pyr.shape == (N_WARMUP, 4, 4) and np.isfinite(pyr).all()):
        raise AssertionError("the pyramid run gave no finite trajectory")
    out, _, _, wall, _ = run_cli("profile", "--set", "runtime.profile=true", "--last", "3")
    trace = out / "checkpoints" / "profile" / "trace.json"
    log("apps profile", frames=4, trace_bytes=trace.stat().st_size if trace.exists() else 0,
        wall_s=wall)
    if not (trace.exists() and trace.stat().st_size > 0):
        raise AssertionError(f"no profiler trace at {trace}")

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

    # host syncs of one steady keyframe frame, without and with the prefetcher
    engine = OnlineReconstructor(cfg, data.rig, device)
    for f in frames[:N_WARMUP]:
        engine.process(f)
    engine.synchronize()
    _, plain_syncs = _count_syncs(lambda: engine.process(frames[N_WARMUP]))
    torch.cuda.set_sync_debug_mode("error")   # the upload must not wait for the card
    try:
        stream = device_prefetch([frames[N_WARMUP + 1]], engine, depth=2)
        frame, packed = next(iter(stream))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    engine.synchronize()
    rec, prefetched_syncs = _count_syncs(lambda: engine.process(frame, packed=packed))
    stream.close()
    log("host syncs", frame=N_WARMUP, keyframe=rec["keyframe"],
        without_prefetch=len(plain_syncs), with_prefetch=len(prefetched_syncs),
        upload_syncs=0, sites_without_prefetch=plain_syncs,
        sites_with_prefetch=prefetched_syncs)
    if not len(prefetched_syncs) < len(plain_syncs):
        raise AssertionError("the prefetcher did not take the upload's sync away")

    # steady frames/s with the prefetcher (depth 2) and without, in turns;
    # the median gap between two frames' records is robust to one slow frame
    def steady(depth_):
        run_cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                          prefetch_depth=depth_))
        eng = OnlineReconstructor(run_cfg, data.rig, device)
        run_frames(eng, frames[:N_WARMUP])
        eng.synchronize()
        stamps = [time.perf_counter()]
        run_frames(eng, frames[N_WARMUP:], lambda rec: stamps.append(time.perf_counter()))
        eng.synchronize()
        rate = N_TIMED / (time.perf_counter() - stamps[0])
        return rate, 1e3 * float(np.median(np.diff(stamps))), eng

    order = (2, 0, 0, 2) * 3
    rates, gaps = {2: [], 0: []}, {2: [], 0: []}
    for depth_ in order:
        rate, gap, engine = steady(depth_)
        rates[depth_].append(rate)
        gaps[depth_].append(gap)
    log("prefetch frame rate", frames=N_TIMED, order=list(order),
        frames_per_s_prefetch=rates[2], frames_per_s_no_prefetch=rates[0],
        median_frame_ms_prefetch=gaps[2], median_frame_ms_no_prefetch=gaps[0],
        median_prefetch=float(np.median(rates[2])),
        median_no_prefetch=float(np.median(rates[0])))

    # snapshots of the last engine (all frames in, the 2M-point pools), then
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
    from online_3d_reconstruction_tpu_torch.stereo import sgm_cuda
    from online_3d_reconstruction_tpu_torch.tools import profile_stages

    sgm_cuda.reset_launch_counts()
    rows = profile_stages.main(384, 512, 64, device=device)
    launches = dict(sgm_cuda.launch_counts)
    want = re.findall(r'bench\(\s*"([^"]+)"',
                      (ROOT / "tools" / "profile_stages.py").read_text())
    want.append(profile_stages.TOTAL)
    names = [name for name, _ in rows]
    if names != want or not all(np.isfinite(ms) and ms > 0 for _, ms in rows):
        raise AssertionError(f"profiler rows {rows} do not match the reference's {want}")
    if not (launches["scan_fwd"] > 0 and launches["scan_bwd"] > 0):
        raise AssertionError(f"K3 was not launched by the profiler: {launches}")
    log("profiler", entry="tools.profile_stages.main(384, 512, 64)",
        stage_ms=dict(rows), launches=launches)
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


def main() -> None:
    device = phase_device()
    import torch

    phase_build()
    rows = phase_kernels(device)
    launches, frames, data, cfg = phase_main_path(device)
    phase_apps(device, frames, data, cfg)
    profiled = phase_profiler(device)
    phase_small_agreement(device)
    rows[0]["launches"] = launches["sgm_path"]
    rows[1]["launches"] = launches["run_total"]
    for row, name in zip(rows, ("sgm_path", "run_total")):
        row["launches_per_frame"] = launches[name] / len(frames)
    rows[2]["launches"] = profiled["scan_fwd"]
    rows[3]["launches"] = profiled["scan_bwd"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
