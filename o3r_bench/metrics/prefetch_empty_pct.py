"""Share of the window's frames (before the profiled slice) whose ``get``
found the prefetcher's queue empty (the counter ``prefetch.queue`` at 0)."""

from o3r_bench.program_trace import counter_values

UNIT, LAYER, MOVES = "%", "prefetch", "frames_per_s"


def read(summary):
    depths = counter_values(summary, "prefetch.queue")
    if not depths:
        return None
    return 100.0 * sum(1 for d in depths if d == 0) / len(depths)
