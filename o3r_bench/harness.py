"""One run of one cell: inputs made on the card from the seed, the port's
online engine warmed up and driven for the window, then the traced slice's
summary and the check against the plain reference.

The timed path is the online path: frames go through
``runtime.prefetch.device_prefetch`` into ``OnlineReconstructor.process``
(the steady step a CUDA graph replay), the window ends with the engine's
``synchronize`` and then ``finish``. Set-up renders the configuration's
closed circuit once and runs the mix's warm-up frames, which reach every
graph variant's capture, a flush and a ``downsample_map``.

Loops (the mix's ``loop``):

- ``closed``: the next frame as soon as ``process`` returns; the window
  runs for ``seconds`` and ends after the first frame that leaves its
  cloud staged (not a flush frame), then synchronizes. ``frames_per_s`` is
  every frame of the window over the window's whole time.
- ``open``: a source releases frame j at t0 + j / rate inside the
  prefetcher's worker, so no frame is packed before it is due; a completion
  thread waits, in order, on an event recorded after each ``process``, and
  a frame's latency runs from its due time to that event's time on the
  device's clock (``_Clock``). The window holds ``ceil(seconds * rate)``
  frames (one more where the last would be a flush frame).

With ``trace`` the profiler records the window's last ``trace_frames``
frames (in the closed loop, the frames after ``seconds``), synchronized at
both ends, inside the span ``o3r_bench.slice``; ``o3r_bench.process`` and
``o3r_bench.next`` wrap every call in every run, traced or not.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import queue
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.config import config_from_dict
from online_3d_reconstruction_tpu_torch.io import (
    CameraIntrinsics,
    FrameData,
    StereoCalibration,
    stereo_rectify,
)
from online_3d_reconstruction_tpu_torch.runtime.pipeline import OnlineReconstructor
from online_3d_reconstruction_tpu_torch.runtime.prefetch import device_prefetch

from o3r_bench import check as chk
from o3r_bench import trace as tr
from o3r_bench.reference import calibration as ref_calibration
from o3r_bench.reference import config as ref_config
from o3r_bench.reference.frame import ReferenceFrames
from o3r_bench.reference.sgm import CONTROL_STORAGE, aggregation_dtype
from o3r_bench.scene.circuit import circuit_poses, prior_pose
from o3r_bench.scene.render import Camera, Scene, render_stereo


def ate_rmse(estimated: np.ndarray, reference: np.ndarray) -> float:
    """Translation RMSE between (N, 4, 4) pose stacks (no alignment: the
    engine anchors to the first prior)."""
    est = np.asarray(estimated, np.float64)[:, :3, 3]
    ref = np.asarray(reference, np.float64)[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum((est - ref) ** 2, axis=1))))


class Inputs:
    """The cell's frames: the configuration's scene and circuit rendered
    once (host float32, as a camera or decoder delivers them), cycled from a
    start phase drawn from the seed, with the priors drawn per stream frame
    from the seed: every seed flies the same scene, in another order and
    with other flight-log noise. At stream frame ``hover`` the rig holds
    still: it repeats the frame before, prior included."""

    def __init__(self, doc: dict, seed: int, device, hover: int = -1):
        self.hover = hover
        rng = np.random.default_rng([seed, 1])
        circ = doc["circuit"]
        self.seed = seed
        self.n = int(circ["frames"])
        self.phase = int(rng.integers(0, self.n))
        self.gt = circuit_poses(circ["waypoints"], circ["step"], self.n, circ["altitude"],
                                circ.get("yaw_wobble", 0.0), circ.get("wobble_seed", 0))
        self.sigma_t = float(doc["priors"]["translation_sigma"])
        self.sigma_r = float(doc["priors"]["rotation_sigma"])
        self.rate = float(doc.get("rate_hz", 10.0))
        sc = doc["scene"]
        scene = Scene(seed=sc["seed"], base_frequency=sc["base_frequency"],
                      octaves=sc["octaves"], speckle_amplitude=sc["speckle_amplitude"],
                      speckle_frequency=sc["speckle_frequency"],
                      plateaus=tuple(tuple(p) for p in sc["plateaus"]),
                      supersample=sc["supersample"])
        sensor = doc["sensor"]
        cams = [Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
                       tuple(c["dist"])) for c in (sensor["left"], sensor["right"])]
        self.calib = StereoCalibration(
            left=CameraIntrinsics(**{**sensor["left"], "dist": tuple(sensor["left"]["dist"])}),
            right=CameraIntrinsics(**{**sensor["right"], "dist": tuple(sensor["right"]["dist"])}),
            rotation=np.asarray(sensor["rotation"], np.float64),
            translation=np.asarray(sensor["translation"], np.float64))
        self.rig = stereo_rectify(self.calib)
        with torch.no_grad():
            self.left, self.right, self.color = render_stereo(
                scene, self.gt, cams[0], cams[1], self.rig.r1, self.calib.rotation,
                self.calib.translation, device)
        self._priors: Dict[int, np.ndarray] = {}

    def circuit_index(self, i: int) -> int:
        return (self.phase + i - (0 <= self.hover <= i)) % self.n

    def prior(self, i: int) -> np.ndarray:
        if i == self.hover:
            return self.prior(i - 1)
        if i not in self._priors:
            self._priors[i] = prior_pose(self.gt[self.circuit_index(i)], self.seed, i,
                                         self.sigma_t, self.sigma_r)
        return self._priors[i]

    def gt_pose(self, i: int) -> np.ndarray:
        return self.gt[self.circuit_index(i)]

    def frame(self, i: int) -> FrameData:
        c = self.circuit_index(i)
        return FrameData(left=self.left[c], right=self.right[c], color=self.color[c],
                         prior_pose=self.prior(i), timestamp=i / self.rate,
                         gt_pose=self.gt[c].astype(np.float32))

    def raw(self, i: int):
        c = self.circuit_index(i)
        return self.left[c], self.right[c], self.color[c], self.prior(i)


class _Slice:
    """The traced slice: the profiler around the window's last ``n`` frames,
    synchronized at both ends; the loop sets ``start``. The profiler is
    started and stopped once in set-up, so that its first start (the
    tracing library's initialisation) does not stall the window, and the
    trace is exported after the window (``export``)."""

    def __init__(self, enabled: bool, n: int, engine):
        self.enabled, self.n, self.engine = enabled, n, engine
        self.start: Optional[int] = None
        self.flags: List[bool] = []
        self.trace: Optional[dict] = None
        self._prof = self._span = None
        self._stopped = False
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        if enabled:
            with torch.profiler.profile(activities=self.activities):
                torch.zeros(1, device=engine.device).add_(1)
                engine.synchronize()

    @property
    def finished(self) -> bool:
        return not self.enabled or self._stopped

    def before(self, k: int) -> None:
        if self.enabled and k == self.start:
            self.engine.synchronize()
            self._prof = torch.profiler.profile(activities=self.activities)
            self._prof.start()
            self._span = torch.profiler.record_function(tr.SLICE)
            self._span.__enter__()

    def after(self, k: int, record: dict) -> None:
        if self._span is None:
            return
        self.flags.append(bool(record["keyframe"]))
        if k == self.start + self.n - 1:
            self.engine.synchronize()
            self._span.__exit__(None, None, None)
            self._prof.stop()
            self._span = None
            self._stopped = True

    def export(self) -> None:
        """The slice's Chrome trace, read back from a temporary file."""
        if not self._stopped:
            return
        fd, path = tempfile.mkstemp(suffix=".json", prefix="o3r_bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                self.trace = json.load(fh)
        finally:
            os.remove(path)
        self._prof = None


class _Clock:
    """Completion times of frames on the host's clock. On the card each
    frame's mark is a timing event recorded after ``process``, and its time
    is read on the device's clock against an event the host saw complete
    (``h0``), so a thread's wait for the interpreter lock adds nothing to
    it; on the CPU a mark is the host's clock when ``process`` returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
            self.e0.synchronize()
        self.h0 = time.perf_counter()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def seconds(self, mark) -> float:
        if not self.cuda:
            return mark
        return self.h0 + 1e-3 * self.e0.elapsed_time(mark)


def _closed_loop(engine, inputs: Inputs, start: int, seconds: float, slc: _Slice,
                 every: int, depth: int):
    records = []
    stream = device_prefetch((inputs.frame(i) for i in itertools.count(start)), engine, depth)
    it = iter(stream)
    t0 = time.perf_counter()
    try:
        for k in itertools.count():
            due = time.perf_counter() - t0 >= seconds
            if due and slc.start is None:
                slc.start = k
            slc.before(k)
            with torch.profiler.record_function(tr.NEXT):
                frame, packed = next(it)
            with torch.profiler.record_function(tr.PROCESS):
                record = engine.process(frame, packed=packed)
            records.append(record)
            slc.after(k, record)
            if due and engine.frame_idx % every and slc.finished:
                break
    finally:
        stream.close()
    engine.synchronize()
    return records, {"window_s": time.perf_counter() - t0}


def _open_loop(engine, inputs: Inputs, start: int, seconds: float, rate: float,
               slc: _Slice, every: int, depth: int):
    n = max(math.ceil(seconds * rate), slc.n if slc.enabled else 1)
    if (start + n) % every == 0:
        n += 1   # the last frame leaves its cloud staged
    slc.start = n - slc.n
    late: List[float] = []

    def source():
        for j in range(n):
            due = t0 + j / rate
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - due)
            yield inputs.frame(start + j)

    clock = _Clock(engine.device)
    t0 = clock.h0 + 0.1
    done: List[Optional[float]] = [None] * n
    marks: "queue.Queue" = queue.Queue()

    def complete():
        while True:
            item = marks.get()
            if item is None:
                return
            j, mark = item
            clock.wait(mark)
            done[j] = clock.seconds(mark)

    waiter = threading.Thread(target=complete, daemon=True)
    waiter.start()
    records = []
    stream = device_prefetch(source(), engine, depth)
    it = iter(stream)
    try:
        for k in range(n):
            slc.before(k)
            with torch.profiler.record_function(tr.NEXT):
                frame, packed = next(it)
            with torch.profiler.record_function(tr.PROCESS):
                record = engine.process(frame, packed=packed)
            marks.put((k, clock.mark()))
            records.append(record)
            slc.after(k, record)
    finally:
        stream.close()
        marks.put(None)
        waiter.join(timeout=300)
    engine.synchronize()
    if waiter.is_alive() or any(d is None for d in done):
        raise RuntimeError("frames of the window never completed")
    latency = [(d - (t0 + j / rate)) * 1e3 for j, d in enumerate(done)]
    return records, {"window_s": max(done) - t0, "latency_ms": latency,
                     "late_ms": [x * 1e3 for x in late]}


def _features_np(feats) -> Dict[str, np.ndarray]:
    kp = feats.keypoints
    return {"xy": kp.xy.cpu().numpy(), "descriptors": kp.descriptors.cpu().numpy(),
            "valid": kp.valid.cpu().numpy(), "points3d": feats.points3d.cpu().numpy(),
            "valid3d": feats.valid3d.cpu().numpy()}


def _pool_np(pool) -> Dict[str, np.ndarray]:
    """A copy of a map pool (``finish`` updates the pools in place)."""
    return {"points": pool.points.cpu().numpy().copy(),
            "colors": pool.colors.cpu().numpy().copy(),
            "valid": pool.valid.cpu().numpy().copy()}


def _collect(engine, plan: chk.Plan):
    """The program's outputs that the check reads, on the host (see
    ``check.RunOutputs``); the staging pool and the main map as the window
    left them."""
    kf_frames = [k.index for k in engine.keyframes]
    events = {}
    for e in plan.needed_events:
        indices, refined = engine._ba_events[e]
        if indices[-1] != kf_frames[e]:
            raise RuntimeError(f"BA event {e} is of frame {indices[-1]}, "
                               f"keyframe {e} is frame {kf_frames[e]}")
        events[e] = refined.cpu().numpy()
    ordinal = {f: o for o, f in enumerate(kf_frames)}
    n = engine.frame_idx
    # every frame fuses (mapping.fuse_every = 1): the pool holds whole frames
    per_frame = engine._frame_points
    staged = list(range(n - int(engine._staging.cursor) // per_frame, n))
    return chk.RunOutputs(
        step_poses=torch.stack(engine.trajectory).cpu().numpy(),
        kf_frames=kf_frames, events=events,
        features={f: _features_np(engine.keyframes[ordinal[f]].features)
                  for f in plan.kf_frames},
        staged_frames=staged, staging=_pool_np(engine._staging),
        main_map=dict(_pool_np(engine.gmap), cursor=int(engine.gmap.cursor)), final_map=(np.zeros((0, 3)), np.zeros((0, 3))))


def device_info(device: torch.device) -> dict:
    """What the contract's ``device`` holds, plus the card's power limit."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        line = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                               "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
        info["power_limit"] = line.splitlines()[0] if line else None
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


def reference_for(doc: dict, device, control: bool = False) -> ReferenceFrames:
    """The plain reference of a configuration file (its own config and rig);
    ``control`` stores SGM in fp8 instead of the configuration's storage."""
    cfg = ref_config.config_from_dict(doc["pipeline"])
    s = doc["sensor"]

    def cam(c):
        return ref_calibration.CameraIntrinsics(**{**c, "dist": tuple(c["dist"])})

    rig = ref_calibration.stereo_rectify(ref_calibration.StereoCalibration(
        left=cam(s["left"]), right=cam(s["right"]),
        rotation=np.asarray(s["rotation"], np.float64),
        translation=np.asarray(s["translation"], np.float64)))
    return ReferenceFrames(cfg, rig, device, storage=CONTROL_STORAGE if control else None)


def run_cell(doc: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, controls: bool = False,
             patch: Optional[Callable] = None) -> dict:
    """Run one cell; returns its measurements, the trace summary (traced
    runs), the numbers compared and their limits (and with ``controls``
    the control's numbers too). ``t_start`` is the process's start on the
    ``time.perf_counter`` clock; ``patch(engine)`` may replace parts of the
    engine (the tests' planted faults)."""
    device = torch.device(device)
    warm = int(mix["warmup_frames"])
    # the last warm-up frame holds still, so that set-up meets a frame that
    # is no keyframe (and captures its graph) in every cell: a survey at
    # 1.2 m a frame meets one only where the priors' noise makes it
    inputs = Inputs({**doc, "rate_hz": mix.get("rate_hz", 10.0)}, seed, device,
                    hover=warm - 1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    cfg = config_from_dict(doc["pipeline"])
    if cfg.mapping.fuse_every != 1:
        raise ValueError("the check reads the staging pool as whole frames: fuse_every must be 1")
    every = max(cfg.mapping.downsample_every, 1)
    depth = cfg.runtime.prefetch_depth
    engine = OnlineReconstructor(cfg, inputs.rig, device)
    if patch is not None:
        patch(engine)
    stream = device_prefetch((inputs.frame(i) for i in range(warm)), engine, depth)
    try:
        for frame, packed in stream:
            engine.process(frame, packed=packed)
    finally:
        stream.close()
    slc = _Slice(trace, int(mix["trace_frames"]), engine)
    engine.synchronize()
    setup_s = time.perf_counter() - t_start
    graphs_before = engine._steps.stats() if engine._steps is not None else None

    if mix["loop"] == "closed":
        records, timing = _closed_loop(engine, inputs, warm, seconds, slc, every, depth)
    else:
        records, timing = _open_loop(engine, inputs, warm, seconds, float(mix["rate_hz"]),
                                     slc, every, depth)

    # the program's outputs, then its state freed before the reference runs
    n = engine.frame_idx
    chk_cfg = doc["check"]
    kf_frames = [k.index for k in engine.keyframes]
    plan = chk.make_plan(seed, kf_frames, n, warm, cfg.ba.window, int(chk_cfg["events"]),
                         int(chk_cfg["frames"]))
    outputs = _collect(engine, plan)
    result = engine.finish(warmup_frames=warm)
    outputs.final_map = (result.map_points, result.map_colors)
    info = device_info(device)
    graphs = result.metrics.get("step_graph")
    trajectory = result.trajectory
    del engine, result
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    window = list(range(warm, n))
    est = trajectory[warm:n]
    gt = np.stack([inputs.gt_pose(i) for i in window])
    priors = np.stack([inputs.prior(i) for i in window])
    ate = ate_rmse(est, gt)
    ate_prior = ate_rmse(priors, gt)
    failed = int(sum(not np.all(np.isfinite(p)) for p in est))

    out = {"frames": len(records), "setup_s": setup_s, "ate_m": ate,
           "ate_prior_m": ate_prior, "ate_ratio": ate / ate_prior if ate_prior > 0 else math.inf,
           "failed": failed, "keyframes": int(sum(r["keyframe"] for r in records)),
           "device": info, "step_graph": graphs, "plan": plan,
           "captures_in_setup": graphs_before and graphs_before["captures"], **timing}
    if mix["loop"] == "closed":
        out["frames_per_s"] = len(records) / timing["window_s"]
    else:
        lat = np.asarray(timing["latency_ms"])
        out["frame_latency_p95_ms"] = float(np.percentile(lat, 95))
        out["late_ms_max"] = float(max(timing["late_ms"]))

    slc.export()
    if slc.trace is not None:
        summary = tr.summarize(slc.trace, slc.flags)
        st = cfg.stereo
        storage = aggregation_dtype(ref_config.config_from_dict(doc["pipeline"]).stereo)
        summary["shapes"] = {"height": st.height, "width": st.width,
                             "max_disparity": st.max_disparity, "num_paths": st.num_paths,
                             "storage_bytes": torch.empty(0, dtype=storage).element_size()}
        summary["window_latency_ms"] = timing.get("latency_ms")
        out["summary"] = summary

    t0 = time.perf_counter()
    with torch.no_grad():
        out["numbers"] = chk.compare(outputs, plan, reference_for(doc, device), inputs.raw,
                                     float(chk_cfg["tolerance"]))
        if controls:
            out["control_numbers"] = chk.compare(outputs, plan,
                                                 reference_for(doc, device, control=True),
                                                 inputs.raw, float(chk_cfg["tolerance"]))
    out["check_s"] = time.perf_counter() - t0
    out["limits"] = dict(chk_cfg["limits"])
    out["correct"] = chk.judge(out["numbers"], out["limits"]) and failed == 0
    return out
