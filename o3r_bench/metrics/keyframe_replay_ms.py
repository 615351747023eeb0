"""Device-busy time of the keyframe variant's graph replays in the slice:
per keyframe frame, the union of the operations that carry its
``cudaGraphLaunch``'s correlation id; mean over keyframe frames."""

UNIT, LAYER, MOVES = "ms", "step graph", "frame_latency_p95_ms"


def read(summary):
    got = [ms for ms, kf in zip(summary["replay_busy_ms"], summary["keyframes"])
           if kf and ms is not None]
    return sum(got) / len(got) if got else None
