"""Census and the cost volume (the stamps ``rectify`` to ``disparity.cost``),
device ms a frame, mean over the window's frames before the profiled slice."""

from o3r_bench.program_trace import stage_mean

UNIT, LAYER, MOVES = "ms", "stereo", "frames_per_s"


def read(summary):
    return stage_mean(summary, "disparity.cost")
