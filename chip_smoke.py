"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of findings:
  1. device: a CUDA card must exist (else exit non-zero, no result), TF32
     must be off; prints the card's name and power limit from nvidia-smi;
  2. build: compiles the CUDA kernels from csrc/ with nvcc (one process per
     source, in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes and at ragged ones (bit-equal), with CUDA-event times
     of both;
  4. main path: ``reconstruct(..., device="cuda")`` on the benchmark scene
     and its full-stack configuration (512x384, D=64, 8-path SGM, distorted
     rig, window BA W=24/L=2048/3 GN iterations with the stereo noise model),
     32 frames; kernel launch counts from that run, ATE against ground truth
     beside prior-only ATE (full stack must reach <= 0.5x), the BA-off
     VO-only ablation, the library's default configuration on the first
     12 frames, disparity quality on one frame, a steady frame rate and a
     per-stage device-time breakdown with the keyframe BA event;
  5. profiler: ``tools.profile_stages.main`` at 384x512x64, every row of the
     reference tool, with K3's launch counts from that run;
  6. agreement of the CUDA and CPU runs on a small input, BA off and on.
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
            ms = cuda_ms(lambda: sgm_cuda.aggregate(cost, 8.0, 32.0, 8), 20)
            plain_ms = cuda_ms(lambda: sgm_cuda.aggregate_plain(cost, 8.0, 32.0, 8),
                               2, warmup=0)
            k1 = dict(name="sgm_path_aggregation", route="cuda",
                      source="online_3d_reconstruction_tpu_torch/csrc/sgm_aggregate.cu",
                      replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:224",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log("kernel K1", paths=paths, shape=[384, 512, 64], equal=True,
            max_abs_err=err)
    rows.append(k1)
    # ragged shapes: D not a multiple of 32 (padding lanes), D = 128 (4 per
    # lane), H and W not multiples of the block, diagonals longer than wide
    for shape in ((37, 45, 40), (33, 70, 128), (70, 33, 8)):
        small = torch.randint(0, 33, shape, generator=gen, dtype=torch.uint8).to(device)
        if not torch.equal(sgm_cuda.aggregate(small, 8.0, 32.0, 8),
                           sgm_cuda.aggregate_plain(small, 8.0, 32.0, 8)):
            raise AssertionError(f"K1 differs from its plain version at {shape}")
    log("kernel K1", paths=8, shapes=[[37, 45, 40], [33, 70, 128], [70, 33, 8]],
        equal=True)

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
    for axis in (0, 1):   # a ragged frame: W not a multiple of the warp
        v = (torch.rand((61, 77), generator=gen) > 0.3).to(torch.float32).to(device)
        st = (torch.rand((61, 77), generator=gen) > 0.7).to(torch.float32).to(device)
        if not torch.equal(sgm_cuda.run_total(v, st, axis),
                           sgm_cuda.run_total_plain(v, st, axis)):
            raise AssertionError(f"K2 (axis {axis}) differs from its plain "
                                 "version at 61x77")
    mask = sgm.speckle_filter(disp, valid, 50, 1.0)
    mask_cpu = sgm.speckle_filter(disp.cpu(), valid.cpu(), 50, 1.0)
    if not torch.equal(mask.cpu(), mask_cpu):
        raise AssertionError("speckle mask on the card differs from the CPU's")

    def four(run):
        return [run(v, st, axis) for v, st, axis in calls]

    ms = cuda_ms(lambda: four(sgm_cuda.run_total), 50)
    plain_ms = cuda_ms(lambda: four(sgm_cuda.run_total_plain), 20)
    rows.append(dict(name="speckle_run_total", route="cuda",
                     source="online_3d_reconstruction_tpu_torch/csrc/speckle_run_total.cu",
                     replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:386",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms))
    log("kernel K2", shape=[384, 512], run_totals_equal=4, mask_equal=True,
        removed=int((valid & ~mask).sum()), max_abs_err=err)
    rows += _scan_pair_rows(device, gen)
    log("kernel times", note="K1: one 8-path aggregation (8 launches); "
        "K2: the 4 run totals of one speckle filter (4 launches); K3 fwd, bwd: "
        "one pass each over the profiler's 384x512x64 f32 vertical pair",
        **{f"{k}_{f}": r[f] for k, r in zip(("K1", "K2", "K3fwd", "K3bwd"), rows)
           for f in ("ms", "plain_ms")})
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
    return [dict(name="sgm_scan_fwd", route="cuda", source=source,
                 replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:63",
                 max_abs_err=err_fwd, ms=ms_fwd, plain_ms=plain_fwd),
            dict(name="sgm_scan_bwd", route="cuda", source=source,
                 replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:79",
                 max_abs_err=err_pair, ms=ms_bwd, plain_ms=plain_bwd)]


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
        prior, left, right, color = unpack_frame(p, st.height, st.width, engine._cc)
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


def phase_main_path(device) -> dict:
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
    per_frame = {"sgm_path": cfg.stereo.num_paths, "run_total": 4}
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
    return launches


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
    launches = phase_main_path(device)
    profiled = phase_profiler(device)
    phase_small_agreement(device)
    rows[0]["launches"] = launches["sgm_path"]
    rows[1]["launches"] = launches["run_total"]
    rows[2]["launches"] = profiled["scan_fwd"]
    rows[3]["launches"] = profiled["scan_bwd"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
