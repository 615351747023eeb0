"""From a frame's receipt by the prefetcher (the end of its
``prefetch.source`` span; in the open loop, its release) to its first device
stamp, median over the window's frames before the profiled slice."""

import statistics

from o3r_bench.program_trace import window

UNIT, LAYER, MOVES = "ms", "entry", "frame_latency_p95_ms"


def read(summary):
    got = [(f["start_ns"] - f["receipt_ns"]) * 1e-6 for f in window(summary) or []
           if f["receipt_ns"] is not None and f["start_ns"] is not None]
    return statistics.median(got) if got else None
