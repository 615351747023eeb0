"""Reduce a ``torch.profiler`` Chrome trace of the traced slice to the
summary that the per-layer metric readers (``metrics/``) read.

The slice is the span ``o3r_bench.slice`` that the harness records around
a few tens of steady frames and the synchronize after them; inside it the
harness records ``o3r_bench.process`` around each ``process`` call and
``o3r_bench.next`` around each wait on the prefetcher. The summary holds:

- ``frames``, ``keyframes`` (a flag per frame, in order), ``wall_s``;
- ``busy_s``: the union of the device's kernels, copies and memsets in the
  slice, and ``device_ops``, their count;
- ``host_launches``: the host's CUDA runtime and driver calls that launch
  work (kernels, graphs, copies, memsets), as ``[host launches]`` of
  ``chip_smoke.py`` counts them;
- ``process_ms`` and ``next_ms``: the spans' durations;
- ``kernels``: per kernel name, [count, seconds];
- ``replay_busy_ms``: per frame, the device-busy time of the operations
  that carry the correlation id of that frame's ``cudaGraphLaunch``
  (None for a frame with no graph launch);
- ``device_top`` and ``idle_gaps``: the longest-running device operations
  by name and the longest idle gaps, each labelled by the host event that
  covered it on the thread of the ``process`` spans.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
SLICE, PROCESS, NEXT = "o3r_bench.slice", "o3r_bench.process", "o3r_bench.next"


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _spans(events, name: str) -> List[dict]:
    return sorted((e for e in events if e.get("name") == name
                   and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])


def summarize(trace: dict, keyframes: Sequence[bool]) -> Dict:
    """The summary of a Chrome trace (``traceEvents``) whose slice ran the
    frames flagged ``keyframes`` (True for a keyframe), in order."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    slices = _spans(events, SLICE)
    if not slices:
        raise ValueError(f"the trace holds no {SLICE!r} span")
    t0 = float(slices[0]["ts"])
    t1 = t0 + float(slices[0]["dur"])

    def inside(e):
        return t0 <= float(e["ts"]) <= t1

    device = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    intervals = [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), t1)) for e in device]
    busy = _union(intervals)
    process = [e for e in _spans(events, PROCESS) if inside(e)]
    nexts = [e for e in _spans(events, NEXT) if inside(e)]
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and inside(e)]

    kernels: Dict[str, List[float]] = {}
    for e in device:
        entry = kernels.setdefault(e["name"], [0, 0.0])
        entry[0] += 1
        entry[1] += float(e["dur"]) * 1e-6

    # each frame's graph replay: the device operations with its correlation id
    by_corr: Dict[int, List[Tuple[float, float]]] = {}
    for e in device:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr.setdefault(int(corr), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    launches = sorted((e for e in runtime if e["name"] == "cudaGraphLaunch"),
                      key=lambda e: e["ts"])
    replay_busy: List[Optional[float]] = []
    for span in process:
        a, b = float(span["ts"]), float(span["ts"]) + float(span["dur"])
        mine = [e for e in launches if a <= float(e["ts"]) <= b]
        if not mine:
            replay_busy.append(None)
            continue
        ops = [iv for e in mine
               for iv in by_corr.get(int((e.get("args") or {}).get("correlation", -1)), [])]
        replay_busy.append(_length(_union(ops)) * 1e-3 if ops else None)

    # idle gaps, labelled by the innermost host event around their middle on
    # the thread that ran the frames
    tid = process[0].get("tid") if process else None
    host = [e for e in events if e.get("tid") == tid and e.get("cat") in
            ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver", "python_function")
            and inside(e) and e["name"] != SLICE] if tid is not None else []
    spans = []
    edges = [(t0, t0)] + busy + [(t1, t1)]
    for (_, end), (start, _) in zip(edges[:-1], edges[1:]):
        if start > end:
            spans.append((end, start))
    spans.sort(key=lambda g: g[0] - g[1])
    gaps = []
    for end, start in spans[:10]:
        mid = 0.5 * (start + end)
        around = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        label = min(around, key=lambda e: float(e["dur"]))["name"] if around else "host: none traced"
        gaps.append((label, (start - end) * 1e-6))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]

    return {
        "frames": len(keyframes),
        "keyframes": [bool(k) for k in keyframes],
        "wall_s": (t1 - t0) * 1e-6,
        "busy_s": _length(busy) * 1e-6,
        "device_ops": len(device),
        "host_launches": sum(1 for e in runtime if e["name"] in LAUNCH_NAMES),
        "process_ms": [float(e["dur"]) * 1e-3 for e in process],
        "next_ms": [float(e["dur"]) * 1e-3 for e in nexts],
        "kernels": kernels,
        "replay_busy_ms": replay_busy,
        "device_top": [[name, secs] for name, (_, secs) in top],
        "idle_gaps": [[label, secs] for label, secs in gaps],
    }
