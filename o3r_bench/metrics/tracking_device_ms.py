"""Tracking against the last keyframe (the stage ``tracking``: matching, the
RANSAC draw and fit, Gauss-Newton), device ms a frame, mean over the
window's frames before the profiled slice."""

from o3r_bench.program_trace import stage_mean

UNIT, LAYER, MOVES = "ms", "odometry", "frames_per_s"


def read(summary):
    return stage_mean(summary, "tracking")
