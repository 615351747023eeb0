"""The map's device time a frame: the stages ``cloud`` (backprojection) and
``insert`` (into the staging pool) and the stamped eager ``flush_staging``
and ``downsample_map``, summed over the window's frames before the profiled
slice and divided by their number."""

from o3r_bench.program_trace import window

UNIT, LAYER, MOVES = "ms", "mapping", "frames_per_s"
STAGES = ("cloud", "insert", "flush_staging", "downsample_map")


def read(summary):
    frames = window(summary)
    if not frames:
        return None
    total = sum(f["stages_ms"].get(s, 0.0) for f in frames for s in STAGES)
    return total / len(frames) if total > 0 else None
