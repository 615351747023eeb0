"""The median frame latency of the window (due time to the pose ready),
beside the end-to-end 95th percentile."""

UNIT, LAYER, MOVES = "ms", "entry", "frame_latency_p95_ms"


def read(summary):
    lat = sorted(summary.get("window_latency_ms") or [])
    if not lat:
        return None
    mid = len(lat) // 2
    return lat[mid] if len(lat) % 2 else 0.5 * (lat[mid - 1] + lat[mid])
