"""Time the loop waited on the prefetcher for each frame (the benchmark's
span around each ``next()`` of ``device_prefetch``), mean over frames."""

UNIT, LAYER, MOVES = "ms", "prefetch", "frames_per_s"


def read(summary):
    ms = summary["next_ms"]
    return sum(ms) / len(ms) if ms else None
