"""Share of the window's wall time (first stamp to last, the frames before
the profiled slice) that no stamped device region covers: a frame's step
(its ``start`` stamp to its last), a ``flush_staging``, a
``downsample_map``."""

from o3r_bench.program_trace import idle_pct, window

UNIT, LAYER, MOVES = "%", "device", "frames_per_s"


def read(summary):
    frames = window(summary)
    return idle_pct(frames) if frames else None
