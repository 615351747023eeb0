"""The readers of the program's own trace (``summary["program"]``,
``o3r_bench.program_trace``) on a hand-written export, and each of them
without one (CPU)."""

import pytest

from o3r_bench.program_trace import PROGRAM_METRICS, idle_pct, window
from o3r_bench.run import reader

MS = 1_000_000   # ns


def _frame(frame, start, stages, keyframe, receipt, flush=None):
    """A frame of an export: ``stages`` (name, ms) after a ``start`` stamp at
    ``start`` ms; ``flush`` (start ms, ms) an eager flush region."""
    stamps, stages_ms, t = {"start": start * MS}, {}, start * MS
    for name, ms in stages:
        t += int(ms * MS)
        stamps[name] = t
        stages_ms[name] = ms
    regions = {"step": [start * MS, t]}
    if flush:
        a, ms = flush
        stamps["flush_staging.start"], stamps["flush_staging"] = a * MS, int((a + ms) * MS)
        stages_ms["flush_staging"] = ms
        regions["flush_staging"] = [a * MS, int((a + ms) * MS)]
    return {"frame": frame, "keyframe": keyframe, "receipt_ns": receipt * MS,
            "start_ns": start * MS, "step_end_ns": t,
            "end_ns": max(b for _, b in regions.values()), "regions": regions,
            "stamps_ns": stamps, "stages_ms": stages_ms}


STEADY = (("unpack", 0.1), ("rectify", 0.2), ("disparity.cost", 1.0),
          ("disparity.aggregate", 0.3), ("disparity", 0.4), ("features", 0.5),
          ("cloud", 0.1), ("tracking", 2.0))


def program():
    """Frames 48-51 of a window from 48, the profiled slice from 51: frame
    48 a keyframe with BA, frame 49 not (with a flush), frame 50 a keyframe;
    frame 51 (in the slice) is left out by every reader."""
    frames = [
        _frame(48, 100, STEADY + (("ba", 3.0), ("insert", 0.2)), True, 96, None),
        _frame(49, 110, STEADY + (("insert", 0.2),), False, 106, (115, 1.0)),
        _frame(50, 120, STEADY + (("ba", 5.0), ("insert", 0.2)), True, 117, None),
        _frame(51, 130, STEADY + (("ba", 50.0), ("insert", 50.0)), True, 0, None),
    ]
    counters = [["prefetch.queue", f, 1, 0, d] for f, d in ((47, 0), (48, 0), (49, 2),
                                                           (50, 1), (51, 0))]
    return {"frames": frames, "window_start": 48, "slice_start": 51,
            "counters": {"fields": ["name", "frame", "thread", "t_ns", "value"],
                         "rows": counters + [["flush", 49, 1, 0, 1000]]}}


WANT = {
    "stereo_device_ms": 1.9,                      # unpack to disparity: 0.2 + 1 + 0.3 + 0.4
    "stereo_cost_device_ms": 1.0,
    "features_device_ms": 0.5,
    "tracking_device_ms": 2.0,
    "ba_device_ms": 4.0,                          # frames 48 and 50
    "keyframe_ba_device_ms": 4.0,
    "mapping_device_ms": (3 * 0.3 + 1.0) / 3,     # cloud + insert a frame, one flush
    "prefetch_empty_pct": 100.0 / 3,              # frame 48 of 48-50
    "release_to_start_ms": 4.0,                   # the median of 4, 4, 3
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_written_program_trace(name):
    assert reader(name).read({"program": program()}) == pytest.approx(WANT[name])


def test_stamped_idle_share_and_window():
    """Frames 48-50: steps of 7.8, 4.8 and 9.8 ms from 100, 110 and 120 ms
    and a 1 ms flush from 115 ms: 23.4 ms busy over 29.8 ms."""
    summary = {"program": program()}
    assert [f["frame"] for f in window(summary)] == [48, 49, 50]
    busy = 7.8 + 4.8 + 1.0 + 9.8
    assert reader("stamped_idle_pct").read(summary) == pytest.approx(100 * (1 - busy / 29.8))
    assert idle_pct(window(summary)[:1]) == pytest.approx(0.0)
    whole = dict(program(), slice_start=None)
    assert [f["frame"] for f in window({"program": whole})] == [48, 49, 50, 51]


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_reader_without_a_program_trace_reads_nothing(name):
    """No ``"program"`` (the harness's summary as it is), or one with no
    frame in the window: None, never a 0."""
    module = reader(name)
    assert module.read({"frames": 32, "busy_s": 1.0, "wall_s": 1.0}) is None
    empty = dict(program(), window_start=60, slice_start=None)
    assert module.read({"program": empty}) is None
    assert (module.UNIT, module.MOVES) in {("ms", "frames_per_s"), ("%", "frames_per_s"),
                                           ("ms", "frame_latency_p95_ms")}
