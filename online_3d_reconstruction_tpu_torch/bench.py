"""Benchmark harness (port of bench.py): frames/s on the full online
pipeline, on one NVIDIA GPU.

    python -m online_3d_reconstruction_tpu_torch.bench [--device cuda] [--detail PATH]

Headline metric: frames/s for stereo -> fused cloud, the complete per-frame
path (rectify, census + SGM disparity with the K1 aggregation and the K2 run
totals, FAST/BRIEF features, matching, RANSAC pose correction, window BA,
voxel fusion) on the reference's synthetic 512x384 survey sequence, with
GT-checked output quality.

Prints exactly ONE JSON line to stdout, the reference's:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
The breakdown goes to stderr and to ``--detail`` (BENCH_DETAIL_TORCH.json;
the reference's BENCH_DETAIL.json is never written). It holds every key of
the reference's detail plus ``device`` (the card's name and power limit as
nvidia-smi gives them, torch and CUDA versions), including:
- ATE ablations: full stack vs VO only (no BA) vs prior-only dead reckoning,
  unaligned and aligned.
- Frame-time attribution: streamed frames (packed and uploaded two frames
  ahead by ``runtime.prefetch.device_prefetch``'s worker, the online path)
  vs frames already on the device (compute + launches only).
- Kernel rows as ``RooflinePoint.report()`` (an ``"invalid"`` entry where no
  time is resolvable or a roof would be exceeded): K1 aggregation (on a card
  only), matching 512x512x256, ``solve_ba`` at W=8/L=256 and at W=64/L=2048
  slot-major, timed by CUDA events on a card.

``--device`` defaults to ``cuda`` and never falls back to the CPU: without a
card, as on any failure, the zero line is printed and the exit code is 1.
``O3R_BENCH_TIMEOUT_S`` (default 1500 s) bounds the run.

vs_baseline: the reference publishes no numbers (BASELINE.md), so the
denominator is its documented proxy of 10 frames/s for the reference OpenCV
SGBM+ORB pipeline at this resolution.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.ba.schur import solve_ba
from online_3d_reconstruction_tpu_torch.ba.testing import make_synthetic_bundle
from online_3d_reconstruction_tpu_torch.config import (
    BAConfig,
    FeatureConfig,
    MappingConfig,
    OdometryConfig,
    PipelineConfig,
    RuntimeConfig,
    StereoConfig,
)
from online_3d_reconstruction_tpu_torch.features.match import match_descriptors
from online_3d_reconstruction_tpu_torch.io import (
    CameraIntrinsics,
    Plateau,
    StereoCalibration,
    SyntheticScene,
    SyntheticSequence,
    make_survey_trajectory,
    stereo_rectify,
)
from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
    OnlineReconstructor,
    _color_stride,
    pack_frame,
    resolve_device,
)
from online_3d_reconstruction_tpu_torch.runtime.prefetch import device_prefetch
from online_3d_reconstruction_tpu_torch.stereo.sgm_cuda import aggregate
from online_3d_reconstruction_tpu_torch.utils import roofline
from online_3d_reconstruction_tpu_torch.utils.metrics import ate_rmse

REFERENCE_PROXY_FPS = 10.0
METRIC = "frames/s/chip (stereo->fused cloud, 512x384xD64, 8-path SGM)"
DETAIL_PATH = "BENCH_DETAIL_TORCH.json"

# the synthetic flight log's declared sensor noise: the estimator is
# configured with the TRUE information weights (1/sigma^2)
PRIOR_T_SIGMA = 0.15   # m
PRIOR_R_SIGMA = 0.01   # rad

# the kernel rows' shapes (bench.py:88, :103, :115, :130): the aggregation
# volume (H, W, D), the two descriptor sets, (W, L, observations) of the
# window solve, (W, L, observations per keyframe) of the slot-major one
KERNEL_SHAPES = {
    "sgm_aggregation": (384, 512, 64),
    "matching": (512, 512),
    "ba_schur": (8, 256, 2048),
    "ba_schur_w64": (64, 2048, 512),
}

_T0 = time.perf_counter()


def _progress(msg: str) -> None:
    """Stderr-only heartbeat; never touches the stdout JSON contract."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _no_nan(x):
    return None if (isinstance(x, float) and not math.isfinite(x)) else x


def device_info(device: torch.device) -> dict:
    """The device a run's numbers come from: on a card its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    info = {"name": "cpu", "power_limit": None, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if device.type == "cuda":
        line = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]
        name, limit = (part.strip() for part in line.rsplit(",", 1))
        info.update(name=name, power_limit=limit)
    return info


def _kernel_benchmarks(device: torch.device) -> dict:
    """Roofline rows of the mandated kernels (bench.py:64-144): disparity
    and BA rooflines, BA iterations/s. Each time is ``measure_amortized``:
    device time between CUDA events over back-to-back calls on a card.
    The reference's zero perturbation of the inputs (there to keep XLA from
    hoisting a call out of its timing loop) has no counterpart: PyTorch runs
    every call. The shapes are ``KERNEL_SHAPES``."""
    shapes = KERNEL_SHAPES
    rng = np.random.default_rng(0)
    out = {}
    _progress("kernel microbenches: start")

    # SGM aggregation, K1: 8 paths on the reference's integer costs, in K1's
    # input form (a contiguous (H, W, D) uint8 volume); the row counts the
    # reference's work (2-byte cells), so the share compares across ports
    h, w, d = shapes["sgm_aggregation"]
    cost = rng.integers(0, 24, (h, w, d))
    if device.type == "cuda":
        cost_u8 = torch.from_numpy(cost.astype(np.uint8)).to(device)
        sec = roofline.measure_amortized(lambda c: aggregate(c, 8.0, 32.0, 8),
                                         (cost_u8,), inner=64)
        point = roofline.sgm_aggregation_model(h, w, d, 8, sec, itemsize=2)
        point.notes = (f"K1 (stereo.sgm_cuda.aggregate), 2 launches: uint8 in, f32 "
                       f"out, {h * w * d * 5 / 1e6:.1f} MB moved; bytes = the "
                       "problem's lower bound at 2 bytes a cell, as the reference")
        out["sgm_aggregation"] = point.report()
        _progress("kernel microbenches: sgm_aggregation done")

    # descriptor matching: the reference's uint32 words in the port's
    # descriptor dtype (int64 words of 32 bits)
    ka, kb = shapes["matching"]
    desc_a = torch.from_numpy(rng.integers(0, 2**32, (ka, 8), dtype=np.uint32)
                              .astype(np.int64)).to(device)
    desc_b = torch.from_numpy(rng.integers(0, 2**32, (kb, 8), dtype=np.uint32)
                              .astype(np.int64)).to(device)
    va = torch.ones(ka, dtype=torch.bool, device=device)
    vb = torch.ones(kb, dtype=torch.bool, device=device)
    sec = roofline.measure_amortized(match_descriptors, (desc_a, desc_b, va, vb), inner=64)
    out["matching"] = roofline.matching_model(ka, kb, 256, sec).report()
    _progress("kernel microbenches: matching done")

    # BA: dense-Schur GN iterations/s at the sliding-window size ...
    gn_iters = 5
    wb, lb, nb = shapes["ba_schur"]
    problem, _, _ = make_synthetic_bundle(np.random.default_rng(1), w=wb, l=lb,
                                          obs_noise=0.02, n_cap=nb, device=device)
    sec = roofline.measure_amortized(
        lambda p: solve_ba(p, iters=gn_iters, damping=1e-4, huber_delta=0.5),
        (problem,), inner=6)
    rep = roofline.ba_schur_model(wb, lb, nb, gn_iters, sec).report()
    rep["ba_iters_per_s"] = _no_nan(gn_iters / sec)
    out["ba_schur"] = rep
    _progress("kernel microbenches: ba_schur done")

    # ... and at the blueprint's window (W=64, L=2048, 512 observations a
    # keyframe), slot-major accumulation
    w64, l64, k64 = shapes["ba_schur_w64"]
    problem64, _, _ = make_synthetic_bundle(
        np.random.default_rng(2), w=w64, l=l64, obs_noise=0.02,
        n_cap=w64 * k64, obs_per_kf=k64, device=device)
    sec = roofline.measure_amortized(
        lambda p: solve_ba(p, iters=gn_iters, damping=1e-4, huber_delta=0.5,
                           slot_major=k64),
        (problem64,), inner=4)
    rep = roofline.ba_schur_model(w64, l64, w64 * k64, gn_iters, sec).report()
    rep["ba_iters_per_s"] = _no_nan(gn_iters / sec)
    out["ba_schur_w64"] = rep
    _progress("kernel microbenches: ba_schur_w64 done")
    return out


def _make_bench_setup(device: "torch.device | str" = "cuda"):
    """The reference's bench configuration (bench.py:147-226): 512x384,
    D=64, 8 paths, the DISTORTED rig (the headline includes the remap),
    scene seed 5 with its plateau, supersample 2, 12 warmup + 20 timed
    frames, 512 keypoints, window BA W=24 / L=2048 / 3 GN iterations with
    the stereo noise model, the 2M-point map, color at stride 4. Returns
    (device, (h, w, d), rig, dataset, cfg, n_warmup, n_timed)."""
    h, w, d = 384, 512, 64
    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, width=w, height=h,
                           dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
    calib = StereoCalibration(left=cam, right=cam, translation=np.array([-0.5, 0.0, 0.0]))
    rig = stereo_rectify(calib)
    # supersample=2: box pixel-footprint anti-aliasing, so subpixel feature
    # localization is physically observable in the oracle
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                           supersample=2)
    # warmup traverses every path: keyframes, a window of keyframes and one
    # periodic map downsample
    n_warmup, n_timed = 12, 20
    poses = make_survey_trajectory(n_warmup + n_timed, altitude=30.0, speed=1.2)
    dataset = SyntheticSequence(scene=scene, rig=rig, poses=poses,
                                prior_translation_sigma=PRIOR_T_SIGMA,
                                prior_rotation_sigma=PRIOR_R_SIGMA, calib=calib)
    cfg = PipelineConfig(
        stereo=StereoConfig(height=h, width=w, max_disparity=d, num_paths=8),
        features=FeatureConfig(max_keypoints=512, fast_threshold=5.0),
        odometry=OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        # the measured-optimal estimator of the reference (tools/ate_lab.py
        # sweeps): W=24 window, landmark capacity scaled to the track count,
        # sigma_disparity=1.0 absorbing SGM's frame-correlated bias, full 3x3
        # ray-coupled information, huber at 3 sigma
        ba=BAConfig(obs_weighting=True, sigma_pixel=0.5, sigma_disparity=1.0,
                    huber_delta=3.0, window=24, max_landmarks=2048, gn_iters=3,
                    prior_position_weight=1.0 / PRIOR_T_SIGMA**2,
                    prior_rotation_weight=1.0 / PRIOR_R_SIGMA**2),
        # color at stride 4 (points at 2): fewer upload bytes a frame
        mapping=MappingConfig(voxel_size=0.25, map_capacity=2_000_000,
                              frame_point_stride=2, color_stride=4,
                              min_depth=1.0, max_depth=60.0),
        runtime=RuntimeConfig(keyframe_translation=0.5, sync_metrics=False),
    )
    return torch.device(device), (h, w, d), rig, dataset, cfg, n_warmup, n_timed


def _render_one(args):
    dataset, i = args
    return dataset[i]


def render(dataset, count: Optional[int] = None) -> list:
    """The first ``count`` frames of ``dataset`` (all by default), rendered
    on the host in up to 8 spawned processes before any timing (set-up,
    never timed)."""
    count = len(dataset) if count is None else count
    workers = max(1, min(8, os.cpu_count() or 1, count))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return list(pool.map(_render_one, [(dataset, i) for i in range(count)]))


def _run_engine(cfg, rig, frames, n_warmup, n_timed, pre_upload: bool,
                device: "torch.device | str"):
    """Warm up, then time ``n_timed`` frames (bench.py:229-277).
    ``pre_upload`` puts the packed uint8 frames on the device first, taking
    the host->device copy off the critical path (compute + launches only);
    otherwise the prefetcher packs and uploads two frames ahead in its
    worker thread, the online path. Returns (elapsed s, result)."""
    engine = OnlineReconstructor(cfg, rig, device)
    _progress(f"engine run (pre_upload={pre_upload}): warmup {n_warmup} frames")
    for f in frames[:n_warmup]:
        engine.process(f)
    engine.synchronize()
    _progress("  warmup complete; timing")

    timed = frames[n_warmup:n_warmup + n_timed]
    packed_list = None
    if pre_upload:
        packed_list = [torch.from_numpy(engine.pack(f, frame_index=n_warmup + i))
                       .to(engine.device) for i, f in enumerate(timed)]
        engine.synchronize()

    t0 = time.perf_counter()
    if packed_list is not None:
        for f, p in zip(timed, packed_list):
            engine.process(f, packed=p)
    else:
        stream = device_prefetch(iter(timed), engine, depth=2)
        try:
            for f, p in stream:
                engine.process(f, packed=p)
        finally:
            stream.close()
    engine.synchronize()
    elapsed = time.perf_counter() - t0
    _progress(f"  timed {n_timed} frames in {elapsed:.2f}s")
    return elapsed, engine.finish(warmup_frames=n_warmup)


def _parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda (the default) raises without a card")
    parser.add_argument("--detail", default=DETAIL_PATH,
                        help=f"where the detail JSON goes (default {DETAIL_PATH})")
    return parser.parse_args(argv)


def main(argv=None, setup=None, frames=None) -> dict:
    """Run the bench; print the one JSON line, write the detail and return
    it. ``setup`` is ``_make_bench_setup``'s tuple (its device entry is
    ignored: ``--device`` decides) and ``frames`` the dataset's frames
    rendered already."""
    args = _parse(argv)
    device = resolve_device(args.device)
    _, (h, w, d), rig, dataset, cfg, n_warmup, n_timed = setup or _make_bench_setup(device)
    if frames is None:
        _progress(f"rendering {len(dataset)} synthetic frames on the host")
        frames = render(dataset)
        _progress("render done")
    gt = np.stack([f.gt_pose for f in frames])
    priors = np.stack([f.prior_pose for f in frames])

    # headline: streamed frames (the online path: upload in the loop)
    elapsed, result = _run_engine(cfg, rig, frames, n_warmup, n_timed,
                                  pre_upload=False, device=device)
    fps = n_timed / elapsed
    ate_full = ate_rmse(result.trajectory, gt)

    # attribution: frames already on the device (compute + launches only)
    elapsed_dev, _ = _run_engine(cfg, rig, frames, n_warmup, n_timed,
                                 pre_upload=True, device=device)
    fps_dev = n_timed / elapsed_dev
    frame_ms, frame_dev_ms = 1e3 * elapsed / n_timed, 1e3 * elapsed_dev / n_timed

    # ATE ablations: the vision stack must earn its keep over dead
    # reckoning on the raw flight-log priors
    ate_prior_only = ate_rmse(priors, gt)
    cfg_vo = cfg.replace(runtime=dataclasses.replace(cfg.runtime, ba_every_keyframe=False))
    _progress("VO-only ablation run")
    _, res_vo = _run_engine(cfg_vo, rig, frames, n_warmup, n_timed,
                            pre_upload=True, device=device)
    ate_vo_only = ate_rmse(res_vo.trajectory, gt)
    # aligned ATE is the odometry protocol: the VO chain anchors at the
    # noisy first prior, so the unaligned number measures that anchor
    ate_vo_aligned = ate_rmse(res_vo.trajectory, gt, align=True)
    ate_prior_aligned = ate_rmse(priors, gt, align=True)

    kernels = _kernel_benchmarks(device)

    cs = _color_stride(cfg.mapping)
    t0 = time.perf_counter()
    for f in frames[n_warmup:n_warmup + n_timed]:
        pack_frame(f, color_stride=cs)
    pack_ms = (time.perf_counter() - t0) / n_timed * 1e3
    upload_bytes = pack_frame(frames[0], color_stride=cs).nbytes

    detail = {
        "kernels": kernels,
        "backend": device.type,
        "frames_timed": n_timed,
        "elapsed_s": elapsed,
        "frames_per_s_per_chip": fps,
        "frame_attribution_ms": {
            "frame_period_streamed": frame_ms,
            "frame_period_device_resident": frame_dev_ms,
            "host_to_device_wire": frame_ms - frame_dev_ms,
            "host_pack": pack_ms,
            "upload_bytes_per_frame": upload_bytes,
        },
        "frames_per_s_device_resident": fps_dev,
        "ate_m": {
            "full_stack": ate_full,
            "vo_only_no_ba": ate_vo_only,
            "vo_only_no_ba_aligned": ate_vo_aligned,
            "prior_only_dead_reckoning": ate_prior_only,
            "prior_only_aligned": ate_prior_aligned,
            "prior_noise_sigma_t": PRIOR_T_SIGMA,
        },
        "map_points": int(len(result.map_points)),
        "stage_means_ms": {k: v for k, v in result.metrics.items() if k.startswith("t_")},
        "resolution": f"{w}x{h}x{d}",
        "vs_baseline_denominator": REFERENCE_PROXY_FPS,
        "device": device_info(device),
    }
    print(json.dumps(detail), file=sys.stderr)
    with open(args.detail, "w") as fh:
        json.dump(detail, fh, indent=2)

    print(json.dumps({
        "metric": METRIC,
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / REFERENCE_PROXY_FPS, 3),
    }), flush=True)
    return detail


def _emergency_exit(reason: str) -> None:
    """Always one JSON line, even if a stage dies or hangs: a zero
    measurement rather than nothing, and exit code 1."""
    print(json.dumps({"error": reason}), file=sys.stderr, flush=True)
    print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "frames/s",
                      "vs_baseline": 0.0}), flush=True)
    os._exit(1)


if __name__ == "__main__":
    import signal

    signal.signal(signal.SIGALRM, lambda *_: _emergency_exit("watchdog timeout"))
    signal.alarm(int(os.environ.get("O3R_BENCH_TIMEOUT_S", "1500")))
    try:
        main()
    except BaseException as e:  # noqa: BLE001  (the contract's zero line, then exit 1)
        _emergency_exit(f"{type(e).__name__}: {e}")
