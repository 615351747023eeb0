"""The stereo stage's device time a frame inside the replayed step, from
the program's own stamps: the ``unpack`` stamp to the ``disparity`` stamp
(rectify, census and cost, the aggregation K1, the selection), mean over
the window's frames before the profiled slice (``o3r_bench.program_trace``)."""

from o3r_bench.program_trace import span_ms, window

UNIT, LAYER, MOVES = "ms", "stereo", "frames_per_s"


def read(summary):
    got = [ms for f in window(summary) or [] for ms in [span_ms(f, "unpack", "disparity")]
           if ms is not None]
    return sum(got) / len(got) if got else None
