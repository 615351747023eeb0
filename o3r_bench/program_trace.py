"""The port's own trace in a benchmark run: the readers' shared helper, and a
runner that measures a cell with the port's tracer on.

``summary["program"]`` is ``engine.trace.export()`` of the port
(``runtime/trace.py``: host spans, device stage stamps mapped onto the host's
clock, counters) plus ``window_start``, the first frame of the window, and
``slice_start``, the first frame of the ``torch.profiler`` slice (None in a
run without one). The readers of the program's metrics use the window's
frames before the slice, so the profiler's cost stays out; each returns None
where the summary has no ``"program"``.

The runner (the benchmark's harness does not turn the port's tracer on)::

    python3 -m o3r_bench.program_trace --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> --profile <0|1> [--out PATH]

runs the cell as ``o3r_bench.run`` does, with the configuration's
``runtime.profile`` set to ``--profile``, and prints one JSON line: the
end-to-end metrics, the program's metrics (``PROGRAM_METRICS``), each
stage's mean device ms, the idle gaps by label, and with ``--trace 1`` the
benchmark's own per-layer metrics and the program's trace against the
profiler's (``consistency``). ``--out`` writes the program's export.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

PROGRAM_METRICS = ("stereo_device_ms", "stereo_cost_device_ms", "features_device_ms",
                   "tracking_device_ms", "ba_device_ms", "mapping_device_ms",
                   "stamped_idle_pct", "prefetch_empty_pct", "release_to_start_ms",
                   "keyframe_ba_device_ms")
STAMP_KERNEL = "trace_stamp_kernel"


def trace_region(stamp: str) -> str:
    """The device region of a stamp (``runtime/trace.py``): ``step``,
    ``flush_staging`` or ``downsample_map``."""
    head = stamp.split(".")[0]
    return head if head in ("flush_staging", "downsample_map") else "step"


def window(summary: dict) -> Optional[List[dict]]:
    """The program's frames of the window before the profiled slice, each
    with its stamps (None without a program trace or frames)."""
    program = summary.get("program")
    if not program or not program.get("frames"):
        return None
    first = program.get("window_start") or 0
    end = program.get("slice_start")
    frames = [f for f in program["frames"]
              if f["frame"] >= first and (end is None or f["frame"] < end)]
    return frames or None


def stage_mean(summary: dict, stage: str, keyframes_only: bool = False) -> Optional[float]:
    """Mean device ms of ``stage`` over the window's frames that ran it."""
    frames = window(summary)
    if frames is None:
        return None
    got = [f["stages_ms"][stage] for f in frames
           if stage in f["stages_ms"] and (f["keyframe"] or not keyframes_only)]
    return sum(got) / len(got) if got else None


def span_ms(frame: dict, first: str, last: str) -> Optional[float]:
    """Device ms from stamp ``first`` to stamp ``last`` of a frame."""
    s = frame["stamps_ns"]
    return (s[last] - s[first]) * 1e-6 if first in s and last in s else None


def idle_pct(frames: List[dict]) -> Optional[float]:
    """Share of the frames' wall time (first stamp to last) that no
    stamped device region covers."""
    regions = sorted(tuple(r) for f in frames for r in f["regions"].values())
    if not regions:
        return None
    busy, cur = 0, None
    for a, b in regions:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += cur[1] - cur[0]
    wall = max(b for _, b in regions) - regions[0][0]
    return 100.0 * (1.0 - busy / wall) if wall > 0 else None


def counter_values(summary: dict, name: str) -> Optional[List]:
    """Values of counter ``name`` at the window's frames before the slice."""
    frames = window(summary)
    if frames is None:
        return None
    first, last = frames[0]["frame"], frames[-1]["frame"]
    c = summary["program"]["counters"]
    col = {k: i for i, k in enumerate(c["fields"])}
    got = [r[col["value"]] for r in c["rows"]
           if r[col["name"]] == name and first <= r[col["frame"]] <= last]
    return got or None


# -- the runner -------------------------------------------------------------------


def _deviation_us(pairs: List[tuple], per_frame: bool = False, rate: bool = False) -> dict:
    """Largest and 99th-percentile |CUPTI - stamp| (us) of (frame, CUPTI ns,
    stamp ns) pairs after one constant offset, an offset per frame, or a
    line (offset and rate, which it also returns)."""
    cupti = np.array([c for _, c, _ in pairs])
    stamp = np.array([t for _, _, t in pairs])
    if rate:
        slope, icept = np.polyfit(stamp - stamp[0], cupti - cupti[0], 1)
        dev = (cupti - cupti[0]) - (slope * (stamp - stamp[0]) + icept)
    else:
        diff = cupti - stamp
        groups = [f for f, _, _ in pairs] if per_frame else [0] * len(pairs)
        centre = {g: np.median([d for d, h in zip(diff, groups) if h == g]) for g in set(groups)}
        dev = diff - np.array([centre[g] for g in groups])
    dev = np.abs(dev) * 1e-3
    out = {"max_us": float(dev.max()), "p99_us": float(np.percentile(dev, 99))}
    if rate:
        out["rate"] = float(slope)
    return out


def _consistency(program: dict, raw: dict, slice_start: int, flags: List[bool]) -> dict:
    """The program's stamps against the profiler's trace of the same slice:
    each keyframe's first-to-last step stamp against its replay's busy time
    and its extent (first operation's start to last one's end) by CUPTI, and
    the stamp kernels' start times against the program's stamps, paired frame
    by frame (the graph's stamps by its launch's correlation, the eager ones
    by the launches inside the frame's span)."""
    frames = {f["frame"]: f for f in program["frames"]}
    events = [e for e in raw.get("traceEvents", []) if e.get("ph") == "X"]

    def corr(e):
        return int((e.get("args") or {}).get("correlation", -1))

    def spans(name):
        return sorted((e for e in events if e.get("name") == name
                       and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])

    slc = spans("o3r_bench.slice")
    t0 = float(slc[0]["ts"]) if slc else float("-inf")
    t1 = t0 + float(slc[0]["dur"]) if slc else float("inf")
    ops: Dict[int, List] = {}
    stamp_kernels: Dict[int, List[float]] = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.setdefault(corr(e), []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if STAMP_KERNEL in e.get("name", ""):
                stamp_kernels.setdefault(corr(e), []).append(float(e["ts"]) * 1e3)
    runtime = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")),
                     key=lambda e: e["ts"])
    busy_ratio, extent_ratio, pairs, unmatched = [], [], [], 0
    process = [e for e in spans("o3r_bench.process") if t0 <= float(e["ts"]) <= t1]
    for k, (span, kf) in enumerate(zip(process, flags)):
        f = frames.get(slice_start + k)
        if f is None:
            continue
        a, b = float(span["ts"]), float(span["ts"]) + float(span["dur"])
        mine = [e for e in runtime if a <= float(e["ts"]) <= b]
        graph = [corr(e) for e in mine if e["name"] == "cudaGraphLaunch"]
        for step, corrs in ((True, graph), (False, [corr(e) for e in mine
                                                     if e["name"] != "cudaGraphLaunch"])):
            got = sorted(t for c in corrs for t in stamp_kernels.get(c, []))
            want = sorted(t for n, t in f["stamps_ns"].items()
                          if (trace_region(n) == "step") == step)
            if step and not graph:
                continue
            if len(got) == len(want):
                pairs.extend((f["frame"], c, t) for c, t in zip(got, want))
            else:
                unmatched += len(want)
        if not (kf and graph and f["start_ns"] is not None):
            continue
        merged: List[List[float]] = []
        for x, y in sorted(iv for c in graph for iv in ops.get(c, [])):
            if merged and x <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], y)
            else:
                merged.append([x, y])
        span_ms = (f["step_end_ns"] - f["start_ns"]) * 1e-6
        busy_ratio.append(span_ms / (sum(y - x for x, y in merged) * 1e-3))
        extent_ratio.append(span_ms / ((merged[-1][1] - merged[0][0]) * 1e-3))
    out = {"keyframe_span_over_busy": busy_ratio, "keyframe_span_over_extent": extent_ratio,
           "stamps_paired": len(pairs), "stamps_unpaired": unmatched}
    if len(pairs) > 2:
        out.update(one_offset=_deviation_us(pairs), offset_per_frame=_deviation_us(pairs, True),
                   offset_and_rate=_deviation_us(pairs, rate=True))
    return out


def _window_counts(program: dict, frames: List[dict]) -> dict:
    """Flushes and downsamples among the window's frames, and the cursor
    values the counters hold."""
    if not frames:
        return {}
    first, last = frames[0]["frame"], frames[-1]["frame"]
    c = program["counters"]
    col = {k: i for i, k in enumerate(c["fields"])}
    out = {"frames": len(frames)}
    for name in ("flush", "downsample"):
        values = [r[col["value"]] for r in c["rows"]
                  if r[col["name"]] == name and first <= r[col["frame"]] <= last]
        out[name] = len(values)
        out[name + "_cursor_last"] = values[-1] if values else None
    return out


def measure(bench: dict, cell: dict, doc: dict, mix: dict, seed: int, seconds: float,
            trace: bool, profile: bool, device="cuda", t_start: Optional[float] = None,
            out_path: str = "") -> dict:
    """One run of ``cell`` with the port's tracing as ``profile`` says;
    returns the runner's line (see the module docstring)."""
    from o3r_bench import harness
    from o3r_bench.run import metrics_of, reader

    doc = json.loads(json.dumps(doc))
    doc["pipeline"].setdefault("runtime", {})["profile"] = bool(profile)
    engines, slices = [], []

    class _Kept(harness._Slice):
        """The harness's slice, kept so that its raw trace can be read."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            slices.append(self)

    original = harness._Slice
    harness._Slice = _Kept
    try:
        out = harness.run_cell(doc, mix, seed, seconds, trace, device,
                               t_start=_T_START if t_start is None else t_start,
                               patch=engines.append)
    finally:
        harness._Slice = original
    program = engines[0].trace.export()
    warm = int(mix["warmup_frames"])
    slc = slices[0]
    slice_start = warm + slc.start if trace and slc.start is not None else None
    program.update(window_start=warm, slice_start=slice_start)
    summary = dict(out.get("summary") or {}, program=program)

    line: Dict = {"workload": cell["name"], "seed": seed, "trace": int(trace),
                  "profile": int(profile), "correct": bool(out["correct"]),
                  "frames": out["frames"], "setup_s": out["setup_s"],
                  "ate_ratio": out["ate_ratio"], "device": out["device"]}
    for name in ("frames_per_s", "frame_latency_p95_ms"):
        if name in out:
            line[name] = out[name]
    if "latency_ms" in out:
        line["frame_latency_p50_ms"] = statistics.median(out["latency_ms"])
    if profile:
        line["program"] = {m: reader(m).read(summary) for m in PROGRAM_METRICS}
        frames = window(summary) or []
        stages = sorted({s for f in frames for s in f["stages_ms"]})
        line["stages_ms"] = {s: stage_mean(summary, s) for s in stages}
        line["calibration"] = {k: program["calibration"][k] for k in ("slope", "error_ns")}
        line["idle_by_label"] = program["idle_by_label"]
        line["idle_gaps"] = program["idle_gaps"]["rows"]
        per_frame = [(f["end_ns"] - f["receipt_ns"]) * 1e-6 for f in frames
                     if f["receipt_ns"] is not None and f["end_ns"] is not None]
        if per_frame:
            line["receipt_to_last_stamp_p50_ms"] = statistics.median(per_frame)
        line["window_counts"] = _window_counts(program, frames)
        if "latency_ms" in out and frames:
            # latency less the program's receipt-to-last-stamp, per frame:
            # what the program's trace does not see of a frame's latency
            lat, late = out["latency_ms"], out["late_ms"]
            rest = [lat[f["frame"] - warm] - late[f["frame"] - warm]
                    - (f["end_ns"] - f["receipt_ns"]) * 1e-6 for f in frames
                    if f["receipt_ns"] is not None and f["end_ns"] is not None]
            line["latency_less_program_p50_ms"] = statistics.median(rest) if rest else None
            line["late_p50_ms"] = statistics.median(late)
            down = {f["frame"] for f in frames if "downsample_map" in f["stages_ms"]}
            for key, keep in (("downsample", True), ("other", False)):
                got = [lat[f["frame"] - warm] for f in frames if (f["frame"] in down) == keep]
                line[f"latency_p50_ms_{key}_frames"] = statistics.median(got) if got else None
        spans = program["spans"]
        col = {k: i for i, k in enumerate(spans["fields"])}
        first = frames[0]["frame"] if frames else 0
        last = frames[-1]["frame"] if frames else -1
        totals: Dict[str, float] = {}
        for r in spans["rows"]:
            if first <= r[col["frame"]] <= last:
                totals[r[col["name"]]] = (totals.get(r[col["name"]], 0.0)
                                          + (r[col["end_ns"]] - r[col["start_ns"]]) * 1e-6)
        n = max(last - first + 1, 1)
        line["span_ms_per_frame"] = {k: v / n for k, v in sorted(totals.items())}
    if trace:
        line["per_layer"] = {m["name"]: reader(m["name"]).read(out["summary"])
                             for m in metrics_of(bench, cell["name"], "per_layer")}
        if profile and slc.trace is not None:
            line["consistency"] = _consistency(program, slc.trace, slice_start, slc.flags)
            kf = [(f["step_end_ns"] - f["start_ns"]) * 1e-6 for f in window(summary) or []
                  if f["keyframe"] and f["start_ns"] is not None]
            line["consistency"]["keyframe_span_ms_before_slice"] = (
                sum(kf) / len(kf) if kf else None)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(program, fh)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--profile", type=int, choices=(0, 1), default=1)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    from o3r_bench.run import load_cell
    import torch

    bench, cell, doc, mix = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = measure(bench, cell, doc, mix, args.seed, args.seconds, bool(args.trace),
                   bool(args.profile), out_path=args.out)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
