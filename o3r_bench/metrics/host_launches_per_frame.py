"""The host's CUDA runtime and driver calls that launch work (kernels,
graph launches, copies, memsets) in the slice, per frame."""

UNIT, LAYER, MOVES = "calls/frame", "step graph", "frames_per_s"


def read(summary):
    return summary["host_launches"] / summary["frames"] if summary["frames"] else None
