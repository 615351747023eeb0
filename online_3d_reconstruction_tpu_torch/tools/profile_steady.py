"""Device time of the bench's steady-frame programs on a warm engine (port
of tools/profile_steady.py), one row per program under the reference
tool's names, at the bench configuration.

    python -m online_3d_reconstruction_tpu_torch.tools.profile_steady [--device cuda]

The engine is warmed on the bench's 12 warmup frames; the rows then time
frame 12: ``unpack_frame``, ``insert_cloud`` into the staging pool, one
``flush_staging`` (the engine runs it once per ``downsample_every`` frames),
``build_problem`` on the engine's window, the slot-major ``solve_ba`` of its
problem, and the two whole steps. The reference's steps are two fused
programs (``_steady_step``, ``_steady_step_kf``); the port runs
``OnlineReconstructor._steady_step`` eagerly, with the keyframe's BA event
off and on: the row name says so. The non-keyframe row is the step with
the BA event off: whether a frame is a keyframe is decided on the host from
its prior before the step, so this is the step any frame that moved less
than ``keyframe_translation`` runs.

A step writes its cloud into the staging pool and slides the BA window, so
the steps run on a scratch copy of the pool and every call starts from the
engine's state (``utils.roofline.measure``'s ``reset``, outside the timed
window); afterwards the engine is as it was before. On a card each row is
device time between CUDA events (host launches included where the host is
the slower); on the CPU, the host clock.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import torch

from online_3d_reconstruction_tpu_torch import bench
from online_3d_reconstruction_tpu_torch.ba.device_tracks import build_problem
from online_3d_reconstruction_tpu_torch.ba.schur import solve_ba
from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
from online_3d_reconstruction_tpu_torch.mapping.global_map import (
    GlobalMap,
    flush_staging,
    insert_cloud,
)
from online_3d_reconstruction_tpu_torch.runtime.pipeline import (
    OnlineReconstructor,
    resolve_device,
    unpack_frame,
)
from online_3d_reconstruction_tpu_torch.utils.roofline import measure, measure_amortized

STEP_SUFFIX = " [port: OnlineReconstructor._steady_step, eager, ba_event={}]"


def _clone(pool: GlobalMap) -> GlobalMap:
    return GlobalMap(*(t.clone() for t in pool))


def _restore(dst: GlobalMap, src: GlobalMap) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def steady_rows(engine: OnlineReconstructor, frame, frame_index: int
                ) -> List[Tuple[str, float]]:
    """Time the steady-frame programs of ``frame`` (the engine's next) on
    the warm ``engine``; print one line per row and return [(name, ms)].
    The engine is left as it was."""
    cfg, dev = engine.cfg, engine.device
    scfg, mcfg = cfg.stereo, cfg.mapping
    rows: List[Tuple[str, float]] = []

    def report(name, sec):
        rows.append((name, sec * 1e3))
        print(f"{name:46s} {sec * 1e3:8.3f} ms", flush=True)

    packed = torch.from_numpy(engine.pack(frame, frame_index=frame_index)).to(dev)
    sec = measure_amortized(
        lambda p: unpack_frame(p, scfg.height, scfg.width, engine._cc,
                               scfg.invalid_value, False), (packed,), inner=16)
    report("unpack_frame (u8 planes -> f32)", sec)

    # a frame's worth of points into a copy of the staging pool as the
    # warmup left it; every call starts from that state
    gen = torch.Generator().manual_seed(0)
    n_pts = engine._frame_points
    cloud = PointCloud((torch.randn((n_pts, 3), generator=gen) * 5.0).to(dev),
                       torch.rand((n_pts, 3), generator=gen).to(dev),
                       torch.ones(n_pts, dtype=torch.bool, device=dev))
    staging = _clone(engine._staging)
    sec = measure(lambda c: insert_cloud(staging, c), (cloud,),
                  reset=lambda: _restore(staging, engine._staging))
    report("insert_cloud (staging pool)", sec)

    gmap = _clone(engine.gmap)

    def reset_pools():
        _restore(gmap, engine.gmap)
        _restore(staging, engine._staging)

    sec = measure(lambda s: flush_staging(gmap, s, mcfg.voxel_size, mcfg.bounds),
                  (staging,), reset=reset_pools)
    report(f"flush_staging (amortize /{mcfg.downsample_every} frames)", sec)
    del gmap

    # BA pieces at the product window configuration, on the engine's window
    state, nm = engine._ba_state, engine._noise_model
    wt, lt = cfg.ba.window, cfg.ba.max_landmarks
    sec = measure_amortized(lambda s: build_problem(s, lt, nm), (state,), inner=8)
    report(f"  ba build_problem (W={wt}/L={lt}, tracks+info)", sec)
    problem, _ = build_problem(state, lt, nm)
    sec = measure_amortized(
        lambda p: solve_ba(
            p, iters=cfg.ba.gn_iters, damping=cfg.ba.damping,
            huber_delta=cfg.ba.huber_delta, anchor_first=False,
            prior_position_weight=cfg.ba.prior_position_weight,
            prior_rotation_weight=cfg.ba.prior_rotation_weight,
            slot_major=cfg.features.max_keypoints),
        (problem,), inner=8)
    report(f"  ba solve_ba (W={wt} slot-major, {cfg.ba.gn_iters} it)", sec)

    # the whole steps, on the scratch pool; each call starts from the
    # engine's pool and window (the keyframe step replaces the window)
    kf = engine.keyframes[-1]
    own_staging = engine._staging

    def reset_step():
        _restore(staging, own_staging)
        engine._ba_state = state

    engine._staging = staging
    try:
        for name, ba_event in (("FUSED _steady_step (non-kf frame)", False),
                               ("FUSED _steady_step_kf (keyframe frame)", True)):
            sec = measure(lambda p, ba_event=ba_event: engine._steady_step(
                p, kf, True, ba_event, False), (packed,), reset=reset_step)
            report(name + STEP_SUFFIX.format(ba_event), sec)
    finally:
        engine._staging, engine._ba_state = own_staging, state
    return rows


def main(argv=None, device: "torch.device | str" = "cuda", setup=None, frames=None
         ) -> List[Tuple[str, float]]:
    """Warm an engine on the bench's warmup frames and time frame
    ``n_warmup`` (``steady_rows``); returns [(name, ms), ...]. ``setup`` is
    ``bench._make_bench_setup``'s tuple and ``frames`` its frames rendered
    already (at least ``n_warmup + 1``). ``argv`` (none by default) may
    name ``--device``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=str(device))
    args = parser.parse_args([] if argv is None else argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", flush=True)
    _, _, rig, dataset, cfg, n_warmup, _ = setup or bench._make_bench_setup(dev)
    if frames is None:
        frames = bench.render(dataset, n_warmup + 2)
    print("rendered", flush=True)
    engine = OnlineReconstructor(cfg, rig, dev)
    for f in frames[:n_warmup]:
        engine.process(f)
    engine.synchronize()
    print("warm engine ready", flush=True)
    return steady_rows(engine, frames[n_warmup], n_warmup)


if __name__ == "__main__":
    main(sys.argv[1:])
