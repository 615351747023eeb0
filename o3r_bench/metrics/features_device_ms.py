"""FAST, BRIEF and the keypoints' 3D lifts (the stage ``features``), device
ms a frame, mean over the window's frames before the profiled slice."""

from o3r_bench.program_trace import stage_mean

UNIT, LAYER, MOVES = "ms", "features", "frames_per_s"


def read(summary):
    return stage_mean(summary, "features")
