"""The engine's tracer (``OnlineReconstructor.trace``): host spans, device
stage stamps and counters on one clock, ``time.perf_counter_ns``.

Host spans. ``span(name, frame)`` times a region of host code: its name,
frame index, thread, start, end and the span that caused it (the enclosing
span on its thread, or one given, such as the prefetcher's span of the
frame). The timing always runs, so the engine's per-frame ``t_<name>_ms``
fields come from it; the span is kept only with tracing on, in a list of
its own thread (no lock on the hot path), bounded, and written out by
``export`` and ``write_chrome``.

Device stamps. With tracing on, ``stamp(name, frame)`` enqueues a one-thread
kernel (``csrc/trace_stamp.cu``) that reads the card's ``%globaltimer`` and
writes it into a device ring ``int64 (ROWS, len(STAMPS))``, row
``frame % ROWS``. Inside the steady step the frame is the packed header's
index, read by the kernel on the device, so a CUDA graph replay stamps its
own frame with nothing from the host. The step's stamps mark the ends of its
stages (``STAMPS``; ``start`` opens the step and clears the row); the eager
regions (``flush_staging``, ``downsample_map``) each have a ``.start``
stamp. A stage's device time is its stamp less the stamp before it in time,
so with the disparity stage's two inner stamps ``disparity.cost`` is census
and the cost volume, ``disparity.aggregate`` the path aggregation (K1) and
``disparity`` the selection (WTA, left-right check, speckle filter). On a
CPU engine a stamp writes ``time.perf_counter_ns()``, so the same ring and
readers run there. The ring is drained without a host wait: every
``ROWS / 2`` frames one asynchronous copy of the finished half into pinned
memory, read at the next drain. Tracing off, nothing is stamped: the
captured graphs and the eager body are then those of an engine without a
tracer, operation for operation.

``sgm_disparity`` stamps its two inner stages through ``mark``, which
stamps only where an engine made its tracer the active one (``activate``)
around its own body, on the engine's thread; other callers stamp nothing.

One clock. The stamps are mapped onto ``perf_counter_ns`` by a line through
two points, one taken at ``reset`` and one at ``export``; each point is the
tightest of ``CALIBRATION_TRIES`` tries of (host time, a stamp,
synchronize, host time), and its error is half that interval. ``export``
returns the spans, the counters, the per-frame stage times, the stamped
device regions' idle gaps labelled by the host spans around them, and the
fit.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# stamp columns, in the order a frame writes them; a name ending in "start"
# opens a region (no stage ends there)
STAMPS = ("start", "unpack", "rectify", "disparity.cost", "disparity.aggregate",
          "disparity", "features", "cloud", "tracking", "ba", "insert",
          "flush_staging.start", "flush_staging", "downsample_map.start", "downsample_map")
_COLUMN = {name: i for i, name in enumerate(STAMPS)}
ROWS = 256                  # frames the device ring holds; drained every ROWS / 2
CALIBRATION_TRIES = 7
MAX_SPANS = 1 << 18         # spans kept per thread (the oldest dropped first)
MAX_FRAMES = 1 << 16        # frames of stamps kept
IDLE_GAPS = 10              # longest idle gaps exported one by one
SPAN_FIELDS = ("id", "name", "frame", "thread", "start_ns", "end_ns", "parent")
COUNTER_FIELDS = ("name", "frame", "thread", "t_ns", "value")


def _region(name: str) -> str:
    """The device region a stamp belongs to: the step (or the first frame's
    compute), ``flush_staging`` or ``downsample_map``."""
    head = name.split(".")[0]
    return head if head in ("flush_staging", "downsample_map") else "step"


class _Thread:
    """One thread's spans, counters and open-span stack."""

    def __init__(self, index: int):
        self.index = index
        self.name = threading.current_thread().name
        self.spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.counters: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.stack: List[int] = []


class _Span:
    """A host span (see ``Tracer.span``); ``parent`` may be set before it
    ends, ``cancel`` keeps it out of the log."""

    __slots__ = ("tracer", "name", "frame", "times", "parent", "start", "id", "_local")

    def __init__(self, tracer: "Tracer", name: str, frame: int, times, parent):
        self.tracer, self.name, self.frame = tracer, name, frame
        self.times, self.parent = times, parent
        self.id = 0

    def __enter__(self) -> "_Span":
        tracer = self.tracer
        if tracer.enabled:
            local = self._local = tracer._thread()
            self.id = next(tracer._ids)
            if self.parent is None:
                self.parent = local.stack[-1] if local.stack else 0
            local.stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def cancel(self) -> None:
        """Keep this span out of the log, open or just closed."""
        if not self.id:
            return
        local = self._local
        if local.stack and local.stack[-1] == self.id:
            local.stack.pop()
        elif local.spans and local.spans[-1][0] == self.id:
            local.spans.pop()
        self.id = 0

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self.times is not None:
            self.times[self.name] = self.times.get(self.name, 0) + end - self.start
        if self.id:
            local = self._local
            local.stack.pop()
            local.spans.append((self.id, self.name, self.frame, local.index, self.start,
                                end, self.parent))


class Tracer:
    """Host spans, device stamps and counters of one engine (see the module
    docstring). ``snapshot()`` gives counts kept elsewhere (the step
    graphs' statistics, the kernels' launch counts) for ``export``."""

    def __init__(self, device: "torch.device | str", enabled: bool = False,
                 snapshot: Optional[Callable[[], dict]] = None):
        self.device = torch.device(device)
        self.enabled = bool(enabled)
        self._cuda = self.device.type == "cuda"
        self._snapshot = snapshot
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._threads: List[_Thread] = []
        self._origins: Dict[int, int] = {}
        self._keyframes: Dict[int, bool] = {}
        self._stamps: "collections.OrderedDict[int, np.ndarray]" = collections.OrderedDict()
        self._pending = None        # (first frame, host buffer, event) of the last drain
        self._read_to = 0           # frames below this were read from the ring
        self._first = 0             # frames below this are left out (``reset``)
        self._last = -1             # the newest frame that ended
        self._points: List[tuple] = []
        if self.enabled:
            self._ring = torch.zeros((ROWS, len(STAMPS)), dtype=torch.int64,
                                     device=self.device)
            self._cal = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
            half = (ROWS // 2, len(STAMPS))
            self._host = [torch.zeros(half, dtype=torch.int64, pin_memory=self._cuda)
                          for _ in range(2)]
            self.reset()

    # -- host spans and counters ---------------------------------------------

    def _thread(self) -> _Thread:
        local = getattr(self._tls, "state", None)
        if local is None:
            local = self._tls.state = _Thread(len(self._threads))
            self._threads.append(local)
        return local

    def span(self, name: str, frame: int, times: Optional[dict] = None,
             parent: Optional[int] = None) -> _Span:
        """``with tracer.span("fusion", frame, times):`` times the block;
        ``times`` (a dict) accumulates its nanoseconds under ``name``."""
        return _Span(self, name, frame, times, parent)

    def counter(self, name: str, frame: int, value) -> None:
        """Record a counter's value (tracing on)."""
        if self.enabled:
            local = self._thread()
            local.counters.append((name, frame, local.index, time.perf_counter_ns(), value))

    def set_origin(self, frame: int, span_id: int) -> None:
        """The span that produced ``frame`` (the prefetcher's), which the
        consumer's spans of that frame name as their parent."""
        if span_id:
            self._origins[frame] = span_id

    def origin(self, frame: int) -> Optional[int]:
        return self._origins.pop(frame, None)

    # -- device stamps --------------------------------------------------------

    def stamp(self, name: str, frame) -> None:
        """Stamp the end of stage ``name`` of ``frame`` (tracing on): an int,
        or a 0-dim float32 tensor on the engine's device (the packed
        header's frame index)."""
        if not self.enabled:
            return
        self._write(self._ring, frame, _COLUMN[name], name == "start")

    def _write(self, ring: torch.Tensor, frame, column: int, clear: bool) -> None:
        rows, cols = ring.shape
        if not self._cuda:
            row = ring[int(frame) % rows]
            if clear:
                row.zero_()
            row[column] = time.perf_counter_ns()
            return
        from online_3d_reconstruction_tpu_torch.utils.cuda_build import check, load_kernels

        if isinstance(frame, torch.Tensor):
            if (frame.dtype != torch.float32 or frame.numel() != 1
                    or frame.device != ring.device):
                raise ValueError("a stamp's frame tensor is the packed header's float32 "
                                 f"index on {ring.device}, got {frame.dtype} on {frame.device}")
            frame_ptr, frame_value = frame.data_ptr(), 0
        else:
            frame_ptr, frame_value = None, int(frame)
        lib = load_kernels()
        index = ring.device.index
        if index is None:
            index = torch.cuda.current_device()
        rc = lib.o3r_trace_stamp(ring.data_ptr(), frame_ptr, frame_value, rows, cols, column,
                                 int(clear), torch._C._cuda_getCurrentRawStream(index))
        check(lib, rc, "o3r_trace_stamp")

    def end_frame(self, frame: int, keyframe: bool) -> None:
        """The host finished ``frame``: note it, and drain the ring's half
        that it completes (one asynchronous copy, read a drain later)."""
        if not self.enabled:
            return
        self._keyframes[frame] = bool(keyframe)
        self._last = max(self._last, frame)
        half = ROWS // 2
        if (frame + 1) % half == 0:
            first = frame + 1 - half
            self._read_pending()
            buf = self._host[(first // half) % 2]
            src = self._ring[(first % ROWS):(first % ROWS) + half]
            event = None
            if self._cuda:
                buf.copy_(src, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                buf.copy_(src)
            self._pending = (first, buf, event)

    def _read_pending(self) -> None:
        if self._pending is None:
            return
        first, buf, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()   # recorded ROWS / 2 frames ago: long complete
        self._keep(first, buf.numpy())

    def _keep(self, first: int, rows: np.ndarray) -> None:
        """Keep the stamp rows of frames first.. that ended and were not read."""
        for k in range(rows.shape[0]):
            frame = first + k
            if frame < max(self._read_to, self._first) or frame > self._last:
                continue
            self._stamps[frame] = rows[k].copy()
            if len(self._stamps) > MAX_FRAMES:
                oldest, _ = self._stamps.popitem(last=False)
                self._keyframes.pop(oldest, None)
        self._read_to = max(self._read_to, first + rows.shape[0])

    def _read_all(self) -> None:
        """Read every ended frame's stamps (waits for the device)."""
        self._read_pending()
        if self._last < self._read_to:
            return
        ring = self._ring.cpu().numpy()
        start = max(self._read_to, self._first, self._last - ROWS + 1)
        frames = np.arange(start, self._last + 1)
        self._keep(start, ring[frames % ROWS])

    # -- the clock ------------------------------------------------------------

    def _synchronize(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def _calibration_point(self) -> tuple:
        """(device ns, host ns, error ns): the tightest of the tries."""
        best = None
        for _ in range(CALIBRATION_TRIES):
            h0 = time.perf_counter_ns()
            self._write(self._cal, 0, 0, False)
            self._synchronize()
            h1 = time.perf_counter_ns()
            point = (int(self._cal[0, 0]), (h0 + h1) // 2, (h1 - h0 + 1) // 2)
            if best is None or point[2] < best[2]:
                best = point
        return best

    def _calibration(self) -> dict:
        """The line from device ns to host ns through the points so far."""
        (d0, h0, e0), (d1, h1, e1) = self._points[0], self._points[-1]
        slope = (h1 - h0) / (d1 - d0) if d1 != d0 else 1.0
        return {"points": [list(p) for p in self._points], "slope": slope,
                "offset_ns": h0 - slope * d0, "error_ns": max(e0, e1)}

    def reset(self) -> None:
        """Drop what was recorded (the frames before the next one, spans,
        counters) and take the clock's first point; waits for the device."""
        if not self.enabled:
            return
        self._synchronize()
        self._pending = None
        self._first = self._read_to = self._last + 1
        self._stamps.clear()
        self._keyframes.clear()
        for local in self._threads:
            local.spans.clear()
            local.counters.clear()
        self._points = [self._calibration_point()]

    # -- export ---------------------------------------------------------------

    def export(self) -> dict:
        """Everything recorded since ``reset`` (see the module docstring);
        waits for the device and takes the clock's second point. Times are
        ``perf_counter_ns`` values."""
        out: dict = {"clock": "perf_counter_ns", "enabled": self.enabled,
                     "counts": self._snapshot() if self._snapshot else {}}
        if not self.enabled:
            return out
        self._synchronize()
        self._read_all()
        self._points = [self._points[0], self._calibration_point()]
        cal = self._calibration()
        threads = list(self._threads)
        spans = sorted((s for t in threads for s in list(t.spans)), key=lambda s: s[4])
        counters = sorted((c for t in threads for c in list(t.counters)), key=lambda c: c[3])
        receipts = {s[2]: s[5] for s in spans if s[1] == "prefetch.source"}
        frames = []
        for frame, row in self._stamps.items():
            frames.append(_frame_record(frame, row, cal, self._keyframes.get(frame),
                                        receipts.get(frame)))
        main = next((s[3] for s in spans if s[1] == "process"), None)
        out.update(
            calibration=cal,
            threads=[t.name for t in threads],
            spans={"fields": list(SPAN_FIELDS), "rows": [list(s) for s in spans]},
            counters={"fields": list(COUNTER_FIELDS), "rows": [list(c) for c in counters]},
            frames=frames,
            **_idle(frames, spans, main))
        return out

    def write_chrome(self, path: str) -> dict:
        """Write ``export()`` as a Chrome trace: one track per host thread,
        one for the device's stamped stages, the counters; returns the
        export."""
        data = self.export()
        with open(path, "w") as fh:
            json.dump(chrome_trace(data), fh)
        return data


def _frame_record(frame: int, row: np.ndarray, cal: dict, keyframe, receipt) -> dict:
    """A frame's stamps on the host clock, its regions and stage times."""
    slope, offset = cal["slope"], cal["offset_ns"]
    stamps = {name: int(round(offset + slope * int(row[c])))
              for c, name in enumerate(STAMPS) if row[c]}
    stages, regions = {}, {}
    prev = None
    for name, t in sorted(stamps.items(), key=lambda kv: kv[1]):
        first, _ = regions.get(_region(name), (t, t))
        regions[_region(name)] = (first, t)
        if not name.endswith("start") and prev is not None:
            stages[name] = (t - prev) * 1e-6
        prev = t
    step = regions.get("step")
    return {"frame": frame, "keyframe": keyframe, "receipt_ns": receipt,
            "start_ns": step[0] if step else None, "step_end_ns": step[1] if step else None,
            "end_ns": max(t for _, t in regions.values()) if regions else None,
            "regions": {k: list(v) for k, v in regions.items()},
            "stamps_ns": stamps, "stages_ms": stages}


def _covering(spans: List[list], t: float) -> Optional[list]:
    """The innermost of properly nested ``spans`` (sorted by start, with
    their running maximum end at index 7) that covers ``t``."""
    i = bisect.bisect_right(spans, t, key=lambda s: s[4]) - 1
    while i >= 0 and spans[i][7] >= t:
        if spans[i][5] >= t:
            return spans[i]
        i -= 1
    return None


def _idle(frames: List[dict], spans: List[tuple], main: Optional[int]) -> dict:
    """Idle gaps between the stamped device regions, each labelled by the
    innermost main-thread span around its middle and the innermost span of
    another thread beside it: the longest ones, and the sum by label."""
    regions = sorted(tuple(r) for f in frames for r in f["regions"].values())
    merged: List[List[int]] = []
    for a, b in regions:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    by_thread: Dict[int, List[list]] = {}
    for s in spans:
        by_thread.setdefault(s[3], []).append(list(s))
    for rows in by_thread.values():
        top = -1
        for s in rows:
            top = max(top, s[5])
            s.append(top)
    gaps, by_label = [], {}
    for (_, end), (start, _) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (end + start)
        own = _covering(by_thread.get(main, []), mid) if main is not None else None
        other = [c for k, rows in by_thread.items() if k != main
                 for c in [_covering(rows, mid)] if c is not None]
        label = own[1] if own else "host: none traced"
        beside = min(other, key=lambda s: s[5] - s[4])[1] if other else None
        frame = own[2] if own else None
        gaps.append([label, beside, (start - end) * 1e-6, frame])
        total = by_label.setdefault(label, [0, 0.0])
        total[0] += 1
        total[1] += (start - end) * 1e-6
    gaps.sort(key=lambda g: -g[2])
    busy = sum(b - a for a, b in merged)
    wall = merged[-1][1] - merged[0][0] if merged else 0
    return {"device": {"busy_ms": busy * 1e-6, "wall_ms": wall * 1e-6,
                       "idle_ms": (wall - busy) * 1e-6},
            "idle_gaps": {"fields": ["label", "beside", "ms", "frame"],
                          "rows": gaps[:IDLE_GAPS]},
            "idle_by_label": by_label}


def chrome_trace(data: dict) -> dict:
    """A Chrome trace (``traceEvents``) of an export: host threads as pid 0,
    the device's stamped stages as pid 1, the counters as counter events."""
    events = [{"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "host"}},
              {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "device"}},
              {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
               "args": {"name": "stamped stages"}}]
    for i, name in enumerate(data.get("threads", [])):
        events.append({"ph": "M", "pid": 0, "tid": i, "name": "thread_name",
                       "args": {"name": name}})
    for sid, name, frame, thread, start, end, parent in data.get("spans", {}).get("rows", []):
        events.append({"ph": "X", "pid": 0, "tid": thread, "name": name, "cat": "span",
                       "ts": start * 1e-3, "dur": (end - start) * 1e-3,
                       "args": {"frame": frame, "id": sid, "parent": parent}})
    for f in data.get("frames", []):
        ordered = sorted(f["stamps_ns"].items(), key=lambda kv: kv[1])
        for (_, t0), (name, t1) in zip(ordered[:-1], ordered[1:]):
            if name in f["stages_ms"]:
                events.append({"ph": "X", "pid": 1, "tid": 0, "name": name, "cat": "stage",
                               "ts": t0 * 1e-3, "dur": (t1 - t0) * 1e-3,
                               "args": {"frame": f["frame"], "keyframe": f["keyframe"]}})
    for name, frame, thread, t, value in data.get("counters", {}).get("rows", []):
        events.append({"ph": "C", "pid": 0, "tid": thread, "name": name, "ts": t * 1e-3,
                       "args": {"value": value, "frame": frame}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"calibration": data.get("calibration"),
                          "counts": data.get("counts")}}


# -- the active tracer of the engine body running on this thread ---------------

_active = threading.local()


@contextlib.contextmanager
def activate(tracer: Tracer, frame):
    """Make ``tracer`` (with tracing on) the one ``mark`` stamps into, for
    ``frame``, on this thread, inside the block."""
    if not tracer.enabled:
        yield
        return
    previous = getattr(_active, "value", None)
    _active.value = (tracer, frame)
    try:
        yield
    finally:
        _active.value = previous


def mark(name: str) -> None:
    """Stamp ``name`` for the active tracer's frame; nothing without one."""
    active = getattr(_active, "value", None)
    if active is not None:
        active[0].stamp(name, active[1])
