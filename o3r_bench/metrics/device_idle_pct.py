"""Share of the slice's wall time in which no kernel, copy or memset ran
on the card."""

UNIT, LAYER, MOVES = "%", "device", "frames_per_s"


def read(summary):
    if summary["wall_s"] <= 0 or summary["device_ops"] == 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["wall_s"])
