"""PyTorch port, the engine's tracer (runtime/trace.py) on the CPU: host
spans across the main thread and the prefetch worker, the stages' stamp
rows (a CPU engine stamps ``perf_counter_ns`` into the same ring), stage
durations, the calibration, the counters, the Chrome trace, and that
tracing leaves the engine's results bit-equal and, off, stamps nothing."""

import json

import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu_torch.config import (
    BAConfig,
    FeatureConfig,
    MappingConfig,
    OdometryConfig,
    PipelineConfig,
    RuntimeConfig,
    StereoConfig,
)
from online_3d_reconstruction_tpu_torch.io.calibration import identity_rig
from online_3d_reconstruction_tpu_torch.io.dataset import SyntheticSequence
from online_3d_reconstruction_tpu_torch.io.synthetic import Plateau, SyntheticScene, nadir_pose
from online_3d_reconstruction_tpu_torch.runtime import pipeline, trace
from online_3d_reconstruction_tpu_torch.runtime.prefetch import device_prefetch
from online_3d_reconstruction_tpu_torch.stereo.sgm import sgm_disparity
from online_3d_reconstruction_tpu_torch.utils import cuda_build

torch.set_num_threads(2)
H, W = 96, 128
STEP_STAMPS = ("start", "unpack", "rectify", "disparity.cost", "disparity.aggregate",
               "disparity", "features", "cloud", "tracking", "insert")


def _config(profile: bool, checkpoint_dir: str = "") -> PipelineConfig:
    return PipelineConfig(
        stereo=StereoConfig(height=H, width=W, max_disparity=16, num_paths=4,
                            use_pallas=False, cost_dtype="float32"),
        features=FeatureConfig(max_keypoints=128, fast_threshold=5.0),
        odometry=OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        mapping=MappingConfig(voxel_size=0.25, map_capacity=20000, frame_point_stride=2,
                              color_stride=4, min_depth=1.0, max_depth=60.0, bounds=512.0,
                              downsample_every=2),
        ba=BAConfig(window=4, max_landmarks=256),
        runtime=RuntimeConfig(keyframe_translation=0.5, ba_every_keyframe=True,
                              profile=profile, prefetch_depth=2, sync_metrics=False,
                              checkpoint_every=2 if checkpoint_dir else 0,
                              checkpoint_dir=checkpoint_dir or "checkpoints"))


@pytest.fixture(scope="module")
def scene():
    rig = identity_rig(fx=150.0, fy=150.0, cx=64.0, cy=48.0, baseline=0.5, width=W, height=H)
    # steps of 0.6 m and one of 0.3 m: keyframes and a frame that is none
    xs = [0.0, 0.6, 1.2, 1.5, 2.1, 2.7, 3.3]
    seq = SyntheticSequence(scene=SyntheticScene(seed=11, plateaus=[Plateau(-3.0, 3.0, -2.0,
                                                                            4.0, 4.0)]),
                            rig=rig, poses=[nadir_pose(x, 0.05 * i, 12.0)
                                            for i, x in enumerate(xs)])
    return rig, [seq[i] for i in range(len(seq))]


def _run(scene, step, profile, tmp_path_factory=None):
    rig, frames = scene
    ckpt = str(tmp_path_factory.mktemp("ckpt")) if tmp_path_factory else ""
    engine = pipeline.OnlineReconstructor(_config(profile, ckpt), rig, "cpu", _step=step)
    records = []
    stream = device_prefetch(frames, engine, 2)
    try:
        for frame, packed in stream:
            records.append(engine.process(frame, packed=packed))
    finally:
        stream.close()
    exported = engine.trace.export()
    return engine, records, exported, engine.finish()


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """Each step path with tracing off and on (checkpoints every 2nd
    keyframe, so every timed span runs)."""
    return {(step, profile): _run(scene, step, profile, tmp_path_factory)
            for step in ("static", "eager") for profile in (False, True)}


def _spans(exported):
    fields = exported["spans"]["fields"]
    return [dict(zip(fields, row)) for row in exported["spans"]["rows"]]


@pytest.mark.parametrize("step", ["static", "eager"])
def test_profile_leaves_trajectory_and_map_bit_equal(runs, step):
    """``runtime.profile`` on and off: trajectory, keyframes, map and the
    records (less their host times) bit for bit, on the graph's static
    buffers and on the eager body; both keep the ``t_<name>_ms`` fields."""
    (_, rec_off, _, off), (_, rec_on, _, on) = runs[(step, False)], runs[(step, True)]
    np.testing.assert_array_equal(on.trajectory, off.trajectory)
    np.testing.assert_array_equal(on.keyframe_indices, off.keyframe_indices)
    np.testing.assert_array_equal(on.map_points, off.map_points)
    np.testing.assert_array_equal(on.map_colors, off.map_colors)

    def plain(records):
        return [{k: v for k, v in r.items() if not k.startswith("t_")} for r in records]

    assert plain(rec_on) == plain(rec_off)
    for records in (rec_on, rec_off):
        timed = set().union(*({k for k in r if k.startswith("t_")} for r in records))
        assert timed == {"t_frame_compute_ms", "t_fusion_ms", "t_step_ms", "t_ba_ms",
                         "t_checkpoint_ms"}
        assert all(v >= 0 for r in records for k, v in r.items() if k.startswith("t_"))
    assert on.metrics["t_step_ms"] > 0


@pytest.mark.parametrize("step", ["static", "eager"])
def test_spans_nest_with_parents_and_frames_across_threads(runs, step):
    """Inside ``process`` every span's parent is a span of the same frame
    on the same thread; ``process`` and ``prefetch.wait`` name the worker's
    ``prefetch`` span of their frame, which holds the frame's source wait,
    packing and put."""
    _, records, exported, _ = runs[(step, True)]
    spans = _spans(exported)
    by_id = {s["id"]: s for s in spans}
    frames = [r["frame"] for r in records]
    prefetch = {s["frame"]: s for s in spans if s["name"] == "prefetch"}
    assert sorted(prefetch) == frames
    main = {s["thread"] for s in spans if s["name"] == "process"}
    assert len(main) == 1 and main != {prefetch[0]["thread"]}
    for s in spans:
        parent = by_id.get(s["parent"])
        if s["name"] in ("process", "prefetch.wait"):
            assert parent is prefetch[s["frame"]], s
        elif s["name"] == "prefetch":
            assert s["parent"] == 0
        else:
            assert parent is not None and parent["frame"] == s["frame"], s
            assert parent["thread"] == s["thread"], s
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"], s
    names = {s["name"] for s in spans}
    assert {"process", "keyframe_policy", "frame_compute", "step", "fusion", "ba",
            "flush_staging", "downsample_map", "downsample_map.cursor_wait", "checkpoint",
            "prefetch.source", "prefetch.pack", "prefetch.put", "prefetch.wait"} <= names
    if step == "static":
        assert {"step.load", "step.sync_keyframe", "step.keep"} <= names
    # the receipt: the end of the frame's source wait
    source = {s["frame"]: s["end_ns"] for s in spans if s["name"] == "prefetch.source"}
    assert [f["receipt_ns"] for f in exported["frames"]] == [source[f] for f in frames]


@pytest.mark.parametrize("step", ["static", "eager"])
def test_every_frame_has_its_stamp_row(runs, step):
    """One stamp row a frame: the step's stages in order (the first frame
    without unpack and tracking), ``ba`` on every keyframe, the eager
    flush and downsample where the frame ran them."""
    _, records, exported, _ = runs[(step, True)]
    rows = {f["frame"]: f for f in exported["frames"]}
    assert sorted(rows) == [r["frame"] for r in records]
    spans = _spans(exported)
    flushed = {s["frame"] for s in spans if s["name"] == "flush_staging"}
    downsampled = {s["frame"] for s in spans if s["name"] == "downsample_map"}
    assert flushed and downsampled
    for r in records:
        f = rows[r["frame"]]
        want = [s for s in STEP_STAMPS if r["frame"] or s not in ("unpack", "tracking")]
        stamps = f["stamps_ns"]
        assert [s for s in trace.STAMPS if s in stamps and trace._region(s) == "step"
                and s != "ba"] == want
        assert ("ba" in stamps) == r["keyframe"] and f["keyframe"] == r["keyframe"]
        assert ("flush_staging" in stamps) == (r["frame"] in flushed)
        assert ("downsample_map" in stamps) == (r["frame"] in downsampled)
    assert not all(r["keyframe"] for r in records)


@pytest.mark.parametrize("step", ["static", "eager"])
def test_stage_durations_sum_to_the_stamped_span(runs, step):
    """Per frame and region, the stage durations add up to its first-to-last
    stamp span; the frame's step span is its ``start`` to its last step
    stamp, and its end the last stamp of all."""
    _, _, exported, _ = runs[(step, True)]
    for f in exported["frames"]:
        for region, (first, last) in f["regions"].items():
            names = [s for s in f["stages_ms"] if trace._region(s) == region]
            assert sum(f["stages_ms"][s] for s in names) == pytest.approx(
                (last - first) * 1e-6, rel=1e-9, abs=1e-9)
        assert f["regions"]["step"] == [f["start_ns"], f["step_end_ns"]]
        assert f["end_ns"] == max(last for _, last in f["regions"].values())
        assert all(v >= 0 for v in f["stages_ms"].values())


def test_tracing_off_stamps_nothing(scene, monkeypatch):
    """With tracing off the static body makes no stamp call (so nothing is
    captured on a card); with it on, every stage is stamped; outside an
    engine's body ``sgm_disparity`` stamps nothing even while an engine
    traces."""
    calls = []
    real = trace.Tracer._write
    monkeypatch.setattr(trace.Tracer, "_write",
                        lambda self, ring, *a: (calls.append(ring is self._ring),
                                                real(self, ring, *a)))
    rig, frames = scene
    for profile in (False, True):
        engine = pipeline.OnlineReconstructor(_config(profile), rig, "cpu", _step="static")
        calls.clear()
        for frame in frames[:3]:
            engine.process(frame)
        stamped = sum(calls)
        assert stamped == 0 if not profile else stamped >= 3 * len(STEP_STAMPS) - 2
    calls.clear()
    img = torch.rand(H, W)
    sgm_disparity(img, img, _config(False).stereo)
    assert calls == []


def test_ring_drains_without_losing_frames():
    """Frames over several ring lengths: every frame's stamps arrive, read
    from the asynchronous drains and, for the last, by ``export``."""
    tracer = trace.Tracer("cpu", enabled=True)
    n = 2 * trace.ROWS + 37
    for frame in range(n):
        tracer.stamp("start", frame)
        tracer.stamp("unpack", frame)
        tracer.end_frame(frame, keyframe=frame % 3 == 0)
    exported = tracer.export()
    assert [f["frame"] for f in exported["frames"]] == list(range(n))
    assert all(set(f["stamps_ns"]) == {"start", "unpack"} for f in exported["frames"])
    # each frame's own stamps: taken in frame order
    starts = [f["start_ns"] for f in exported["frames"]]
    assert starts == sorted(starts) and len(set(starts)) == n
    assert [f["keyframe"] for f in exported["frames"]] == [i % 3 == 0 for i in range(n)]
    tracer.reset()
    tracer.stamp("start", n)
    tracer.end_frame(n, keyframe=False)
    assert [f["frame"] for f in tracer.export()["frames"]] == [n]


def test_calibration_maps_monotonic_stamps_to_monotonic_host_times(runs):
    """Two points, each the tightest of the tries: device and host times
    rise together, the slope is positive, and the frames' mapped stamps
    rise with the frame index and with the stage order."""
    _, _, exported, _ = runs[("static", True)]
    cal = exported["calibration"]
    (d0, h0, e0), (d1, h1, e1) = cal["points"]
    assert d1 > d0 and h1 > h0 and cal["slope"] > 0 and cal["error_ns"] == max(e0, e1) >= 0
    device = np.sort(np.random.default_rng(0).integers(d0, d1, 1000))
    host = cal["offset_ns"] + cal["slope"] * device
    assert np.all(np.diff(host) >= 0)
    starts = [f["start_ns"] for f in exported["frames"]]
    assert starts == sorted(starts)
    for f in exported["frames"]:
        order = [f["stamps_ns"][s] for s in STEP_STAMPS if s in f["stamps_ns"]]
        assert order == sorted(order)


def test_counters_and_counts(runs):
    """The prefetcher's queue depth at each get, the host's cursor bound
    after each flush, the device cursor after each downsample, and the
    counts kept elsewhere, exported as they are."""
    engine, records, exported, _ = runs[("static", True)]
    fields = exported["counters"]["fields"]
    rows = [dict(zip(fields, r)) for r in exported["counters"]["rows"]]
    queue = [r for r in rows if r["name"] == "prefetch.queue"]
    assert [r["frame"] for r in queue] == [r["frame"] for r in records]
    assert all(0 <= r["value"] <= 2 for r in queue)
    flushes = [r for r in rows if r["name"] == "flush"]
    assert flushes and [r["value"] for r in flushes] == sorted(r["value"] for r in flushes)
    downsamples = [r for r in rows if r["name"] == "downsample"]
    assert downsamples and all(isinstance(r["value"], int) for r in downsamples)
    assert set(exported["counts"]) == {"step_graph", "launch_counts"}
    # every kernel of the one registry, K5's among them
    launches = exported["counts"]["launch_counts"]
    assert set(launches) == set(cuda_build.launch_counts) and "voxel_reduce" in launches
    assert launches["sgm_path"] == 0   # the CPU's plain forms
    device = exported["device"]
    assert device["wall_ms"] >= device["busy_ms"] > 0
    gaps = exported["idle_gaps"]
    assert gaps["fields"] == ["label", "beside", "ms", "frame"] and gaps["rows"]
    assert sum(n for n, _ in exported["idle_by_label"].values()) >= len(gaps["rows"])


def test_write_chrome_loads_as_json(runs, tmp_path):
    """The Chrome trace: the host threads' spans, the device's stamped
    stages, the counters, the calibration; it loads as JSON."""
    engine, _, _, _ = runs[("static", True)]
    path = tmp_path / "trace.json"
    engine.trace.write_chrome(str(path))
    with open(path) as fh:
        data = json.load(fh)
    events = data["traceEvents"]
    assert {e["ph"] for e in events} == {"M", "X", "C"}
    stages = [e for e in events if e.get("cat") == "stage"]
    assert stages and all(e["pid"] == 1 and e["dur"] >= 0 for e in stages)
    assert {e["name"] for e in events if e.get("cat") == "span"} >= {"process", "prefetch"}
    assert data["otherData"]["calibration"]["slope"] > 0
