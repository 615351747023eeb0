"""Kernels, copies and memsets the card ran in the slice, per frame."""

UNIT, LAYER, MOVES = "ops/frame", "device", "frames_per_s"


def read(summary):
    return summary["device_ops"] / summary["frames"] if summary["frames"] else None
