"""The window bundle adjustment of a keyframe (the stage ``ba``), device ms,
mean over the keyframes of the window before the profiled slice."""

from o3r_bench.program_trace import stage_mean

UNIT, LAYER, MOVES = "ms", "window BA", "frame_latency_p95_ms"


def read(summary):
    return stage_mean(summary, "ba", keyframes_only=True)
