"""Command-line entry point of the online reconstruction (port of
apps/reconstruct.py), on one device.

  --first/--last        frame range
  --voxel-size          mapping.voxel_size
  --stride              mapping.frame_point_stride
  --disparity-dir       precomputed-disparity mode
  --set sec.key=value   any config knob
  --device              cuda (default; raises without a card) or cpu

Datasets: the synthetic oracle (``--synthetic N``) or image folders named by
timestamp with a flight-log CSV (``--left/--right/--flight-log``, optional
``--calib``). Outputs under ``--output``: map.ply (map.pcd, viewer.html,
metrics.jsonl on request), trajectory.tum, summary.json, and snapshots in
checkpoints/ (``--checkpoint-every``, ``--resume``). The frames run through
``runtime.pipeline.run_frames``, the path of ``reconstruct``: packed and
uploaded ahead by the prefetcher, profiled with ``runtime.profile``.

  python -m online_3d_reconstruction_tpu_torch.apps.reconstruct --synthetic 50 --output out/
  python -m online_3d_reconstruction_tpu_torch.apps.reconstruct --left data/left \\
      --right data/right --flight-log data/log.csv --calib calib.json --output out/ --resume
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_argument_group("dataset")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="run N synthetic survey frames (the test oracle)")
    src.add_argument("--left", help="left image directory")
    src.add_argument("--right", help="right image directory")
    src.add_argument("--flight-log", help="flight log CSV (timestamp + pose)")
    src.add_argument("--disparity-dir", help="precomputed disparity .npy dir")
    src.add_argument("--calib", help="calibration JSON (see io/calibration.py)")
    src.add_argument("--first", type=int, default=0, help="first frame index")
    src.add_argument("--last", type=int, default=-1, help="last frame index (inclusive)")

    cfg = p.add_argument_group("config")
    cfg.add_argument("--config", help="YAML/JSON pipeline config file")
    cfg.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                     help="config override, e.g. --set stereo.max_disparity=128")
    cfg.add_argument("--voxel-size", type=float, help="map voxel leaf size (m)")
    cfg.add_argument("--stride", type=int, help="pixel subsample stride")
    cfg.add_argument("--device", default="cuda",
                     help="torch device: cuda (default, no fallback) or cpu")

    out = p.add_argument_group("output")
    out.add_argument("--output", default="out", help="output directory")
    out.add_argument("--ply", action="store_true", default=True, help="write map.ply")
    out.add_argument("--pcd", action="store_true", help="also write map.pcd")
    out.add_argument("--viewer", action="store_true",
                     help="write a standalone interactive viewer.html")
    out.add_argument("--viewer-every", type=int, default=0, metavar="K",
                     help="also re-export viewer.html every K keyframes during the run")
    out.add_argument("--metrics", action="store_true", help="write metrics.jsonl")
    out.add_argument("--quiet", action="store_true", help="suppress per-frame prints")

    ckpt = p.add_argument_group("checkpointing")
    ckpt.add_argument("--checkpoint-every", type=int, default=0,
                      help="snapshot every N keyframes (0 = off)")
    ckpt.add_argument("--resume", action="store_true",
                      help="resume from <output>/checkpoints/snapshot.npz")
    return p.parse_args(argv)


def _parse_value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def build_config(args):
    """The pipeline configuration of the command line (the reference app's
    rules); snapshots and the profiler trace go under ``<output>/checkpoints``
    unless ``--set runtime.checkpoint_dir=...`` says otherwise."""
    from online_3d_reconstruction_tpu_torch.config import load_config

    # the measured estimator preset (whitened 3x3 stereo information, W=24
    # with its landmark capacity, 3 GN iterations), applied only when no
    # --config file is given; every entry yields to --set
    overrides = {}
    if not args.config:
        overrides.update({
            "ba.obs_weighting": True,
            "ba.sigma_pixel": 0.5,
            "ba.sigma_disparity": 1.0,
            "ba.huber_delta": 3.0,
            "ba.window": 24,
            "ba.max_landmarks": 2048,
            "ba.gn_iters": 3,
        })
    overrides["runtime.checkpoint_dir"] = os.path.join(args.output, "checkpoints")
    for item in args.set:
        key, _, val = item.partition("=")
        if not val:
            raise SystemExit(f"--set expects SEC.KEY=VAL, got {item!r}")
        overrides[key] = _parse_value(val)
    if args.voxel_size is not None:
        overrides["mapping.voxel_size"] = args.voxel_size
    if args.stride is not None:
        overrides["mapping.frame_point_stride"] = args.stride
    if args.checkpoint_every:
        overrides["runtime.checkpoint_every"] = args.checkpoint_every
    if args.metrics:
        overrides["runtime.metrics_path"] = os.path.join(args.output, "metrics.jsonl")
    if args.disparity_dir:
        overrides.setdefault("runtime.use_precomputed_disparity", True)
    return load_config(args.config, overrides)


def _load_rig(args, cfg):
    from online_3d_reconstruction_tpu_torch.io import (
        identity_rig,
        load_calibration_json,
        stereo_rectify,
    )

    if args.calib:
        return stereo_rectify(load_calibration_json(args.calib))
    h, w = cfg.stereo.height, cfg.stereo.width
    return identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                        width=w, height=h)


def _build_dataset(args, rig):
    from online_3d_reconstruction_tpu_torch.io import (
        ImageFolderSequence,
        Plateau,
        SyntheticScene,
        SyntheticSequence,
        make_survey_trajectory,
    )

    if args.synthetic:
        scene = SyntheticScene(seed=5, plateaus=[Plateau(-6, 6, -4, 8, 8.0)])
        poses = make_survey_trajectory(args.synthetic, altitude=30.0, speed=1.2)
        return SyntheticSequence(scene=scene, rig=rig, poses=poses)
    if not (args.left and args.right and args.flight_log):
        raise SystemExit("need --synthetic N, or --left/--right/--flight-log")
    return ImageFolderSequence(left_dir=args.left, right_dir=args.right,
                               flight_log=args.flight_log,
                               disparity_dir=args.disparity_dir)


def main(argv=None) -> int:
    args = _parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    cfg = build_config(args)
    rig = _load_rig(args, cfg)
    dataset = _build_dataset(args, rig)

    from online_3d_reconstruction_tpu_torch.io import export_html
    from online_3d_reconstruction_tpu_torch.io.export import (
        save_pcd,
        save_ply,
        save_trajectory_tum,
    )
    from online_3d_reconstruction_tpu_torch.runtime.checkpoint import load_checkpoint
    from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
        OnlineReconstructor,
        run_frames,
    )

    engine = OnlineReconstructor(cfg, rig, args.device)
    start = 0
    snap = os.path.join(cfg.runtime.checkpoint_dir, "snapshot.npz")
    if args.resume and os.path.exists(snap):
        load_checkpoint(engine, snap)
        start = engine.frame_idx
        print(f"resumed from {snap} at frame {start}", file=sys.stderr)

    viewer_path = os.path.join(args.output, "viewer.html")
    last = args.last if args.last >= 0 else len(dataset) - 1

    def on_record(rec):
        if (args.viewer_every and rec["keyframe"]
                and len(engine.keyframes) % args.viewer_every == 0):
            export_html(viewer_path, *engine.snapshot_map())
        if not args.quiet:
            stages = " ".join(f"{k[2:-3]}={v:.0f}ms" for k, v in rec.items()
                              if k.startswith("t_"))
            vo = rec.get("used_vo")
            print(f"frame {rec['frame']:5d} kf={int(rec['keyframe'])} "
                  f"vo={'-' if vo is None else int(vo)} inl={rec.get('vo_inliers', '-')} "
                  f"map={rec['map_points']:8d} {stages}", file=sys.stderr)

    t0 = time.perf_counter()
    frames = (dataset[i] for i in range(max(args.first, start), last + 1))
    run_frames(engine, frames, on_record)
    result = engine.finish()
    elapsed = time.perf_counter() - t0

    if args.ply:
        save_ply(os.path.join(args.output, "map.ply"), result.map_points,
                 result.map_colors)
    if args.pcd:
        save_pcd(os.path.join(args.output, "map.pcd"), result.map_points,
                 result.map_colors)
    if args.viewer or args.viewer_every:
        export_html(viewer_path, result.map_points, result.map_colors,
                    result.trajectory)
    save_trajectory_tum(os.path.join(args.output, "trajectory.tum"), result.trajectory)
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(result.metrics, f, indent=2)
    print(f"{result.metrics['frames']} frames in {elapsed:.1f}s "
          f"({result.metrics.get('frames_per_s', 0):.2f} fps), "
          f"{len(result.map_points)} map points, "
          f"{result.metrics['keyframes']} keyframes on {engine.device} -> {args.output}/",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
