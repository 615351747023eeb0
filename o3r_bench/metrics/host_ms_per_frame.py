"""Host time of each ``OnlineReconstructor.process`` call in the slice
(the benchmark's span around the call), mean over frames."""

UNIT, LAYER, MOVES = "ms", "entry", "frames_per_s"


def read(summary):
    ms = summary["process_ms"]
    return sum(ms) / len(ms) if ms else None
