"""The trace reader and every per-layer metric reader on a hand-written
Chrome trace (CPU)."""

import pytest

from o3r_bench import roofline
from o3r_bench import trace as tr
from o3r_bench.run import reader


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def fixture_trace():
    """Two frames in a 1000 us slice: frame 0 a keyframe (graph launch,
    correlation 7), frame 1 not (graph launch, correlation 9); the
    prefetcher's copy on another thread; an eager memset after the frames."""
    ev = [
        _x(tr.SLICE, "user_annotation", 0, 1000),
        _x(tr.NEXT, "user_annotation", 10, 20),
        _x(tr.PROCESS, "user_annotation", 40, 100),
        _x("cudaGraphLaunch", "cuda_runtime", 50, 30, corr=7),
        _x("cudaMemcpyAsync", "cuda_runtime", 90, 5, corr=8),
        _x(tr.NEXT, "user_annotation", 150, 10),
        _x(tr.PROCESS, "user_annotation", 170, 100),
        _x("cudaGraphLaunch", "cuda_runtime", 180, 30, corr=9),
        _x("aten::zero_", "cpu_op", 600, 300),
        _x("cudaMemsetAsync", "cuda_runtime", 610, 5, corr=10),
        _x("cudaMemcpyAsync", "cuda_runtime", 20, 5, tid=2, corr=11),
        _x("cudaStreamSynchronize", "cuda_runtime", 900, 90),
        # device: copy of the prefetcher, frame 0's replay (K1, K2, other), frame 1's
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 30, 10, corr=11),
        _x("sgm_half_kernel", "kernel", 100, 150, corr=7),
        _x("finish_half_kernel", "kernel", 250, 50, corr=7),
        _x("run_total_rows_kernel", "kernel", 300, 20, corr=7),
        _x("void gemm_small", "kernel", 400, 100, corr=7),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 500, 10, corr=8),
        _x("sgm_half_kernel", "kernel", 520, 80, corr=9),
        _x("run_total_cols_kernel", "kernel", 600, 20, corr=9),
        _x("Memset (Device)", "gpu_memset", 700, 10, corr=10),
        # outside the slice: ignored
        _x("sgm_half_kernel", "kernel", 2000, 100, corr=12),
        _x(tr.PROCESS, "user_annotation", 3000, 100),
    ]
    return {"traceEvents": ev + [{"ph": "M", "name": "process_name"}]}


@pytest.fixture
def summary():
    s = tr.summarize(fixture_trace(), [True, False])
    s["shapes"] = {"height": 384, "width": 512, "max_disparity": 64, "num_paths": 8,
                   "storage_bytes": 2}
    s["window_latency_ms"] = [30.0, 10.0, 20.0, 40.0]
    return s


def test_summary_numbers(summary):
    assert summary["frames"] == 2 and summary["keyframes"] == [True, False]
    assert summary["wall_s"] == pytest.approx(1000e-6)
    # busy: 30-40, 100-320, 400-510, 520-620, 700-710 -> 10+220+110+100+10
    assert summary["busy_s"] == pytest.approx(450e-6)
    assert summary["device_ops"] == 9
    # 2 graph launches, 3 copies, 1 memset; the synchronize is no launch
    assert summary["host_launches"] == 5
    assert summary["process_ms"] == [pytest.approx(0.1), pytest.approx(0.1)]
    assert summary["next_ms"] == [pytest.approx(0.02), pytest.approx(0.01)]
    assert summary["kernels"]["sgm_half_kernel"] == [2, pytest.approx(230e-6)]
    # frame 0's replay: 100-320 and 400-500 under correlation 7 -> 320 us
    assert summary["replay_busy_ms"] == [pytest.approx(0.32), pytest.approx(0.1)]
    assert summary["device_top"][0] == ["sgm_half_kernel", pytest.approx(230e-6)]
    # the idle gaps, longest first, each by the innermost host event on the
    # frames' thread around its middle
    gaps = [(round(s * 1e6), label) for label, s in summary["idle_gaps"]]
    assert gaps == [(290, "aten::zero_"), (80, "host: none traced"), (80, "aten::zero_"),
                    (60, "cudaGraphLaunch"), (30, tr.NEXT), (10, "host: none traced")]


def test_every_reader(summary):
    expect = {
        "host_ms_per_frame": 0.1,
        "prefetch_wait_ms": 0.015,
        "host_launches_per_frame": 2.5,
        "device_idle_pct": 55.0,
        "device_ops_per_frame": 4.5,
        "k1_roofline_pct": 100.0 * 2 * roofline.sgm_aggregation_bound_s(384, 512, 64, 8, 2)
        / 280e-6,
        "k2_roofline_pct": 100.0 * 2 * roofline.speckle_run_totals_bound_s(384, 512) / 40e-6,
        "frame_latency_p50_ms": 25.0,
        "keyframe_replay_ms": 0.32,
    }
    for name, value in expect.items():
        assert reader(name).read(summary) == pytest.approx(value), name


def test_readers_find_nothing_to_read():
    """An empty slice gives no number, never a 0 share."""
    s = tr.summarize({"traceEvents": [_x(tr.SLICE, "user_annotation", 0, 100)]}, [])
    s["shapes"] = {"height": 8, "width": 8, "max_disparity": 8, "num_paths": 8,
                   "storage_bytes": 2}
    for name in ("host_ms_per_frame", "prefetch_wait_ms", "host_launches_per_frame",
                 "device_idle_pct", "device_ops_per_frame", "k1_roofline_pct",
                 "k2_roofline_pct", "frame_latency_p50_ms", "keyframe_replay_ms"):
        assert reader(name).read(s) is None, name


def test_roofline_bounds():
    cells = 384 * 512 * 64
    assert roofline.sgm_aggregation_bound_s(384, 512, 64, 8, 2) == pytest.approx(
        max(3 * cells / 3.35e12, 88 * cells / 67e12))
    assert roofline.speckle_run_totals_bound_s(384, 512) == pytest.approx(
        48 * 384 * 512 / 3.35e12)
