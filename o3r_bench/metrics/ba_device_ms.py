"""The window bundle adjustment inside the step (the stage ``ba``), device ms
a frame that runs it, mean over the window's frames before the profiled
slice."""

from o3r_bench.program_trace import stage_mean

UNIT, LAYER, MOVES = "ms", "window BA", "frames_per_s"


def read(summary):
    return stage_mean(summary, "ba")
