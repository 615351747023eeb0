"""PyTorch port, the measurement programs: the bench (the port of bench.py)
and the two profilers beside it (tools/profile_steady.py,
tools/profile_stage_parts.py), on the CPU at small sizes.

The bench's ``_run_engine`` is held against the reference's on the 8-frame
distorted 256x192 sequence of test_torch_pipeline.py with the product
estimator, 4 warmup and 4 timed frames, the reference's RANSAC draws
injected and its gather remap selected (as test_torch_pipeline_ba.py does):
keyframes equal, every pose within 1e-3 m and 1e-3 rad, map sizes within
0.5%. ``main``'s output keeps the reference's contract (one stdout line
with its four keys; the detail with every key of BENCH_DETAIL.json plus
``device``), its kernel rows count the reference models' bytes, and each
profiler prints every row of its reference source."""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
from online_3d_reconstruction_tpu.stereo import rectify as jrectify
from online_3d_reconstruction_tpu.utils import roofline as jroofline
from online_3d_reconstruction_tpu_torch import bench
from online_3d_reconstruction_tpu_torch.odometry import rigid
from online_3d_reconstruction_tpu_torch.runtime.pipeline import OnlineReconstructor
from online_3d_reconstruction_tpu_torch.tools import profile_stage_parts, profile_steady
from tests.test_torch_pipeline import H, W, _config, _jax_samples, sequence  # noqa: F401
from tests.test_torch_pipeline_ba import _PRODUCT_BA, _angle
from tests.test_torch_shared import port

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
N_WARMUP, N_TIMED = 4, 4
SMALL_KERNELS = {"sgm_aggregation": (24, 32, 16), "matching": (64, 48),
                 "ba_schur": (4, 32, 128), "ba_schur_w64": (6, 64, 16)}


@pytest.fixture(scope="module", autouse=True)
def _reference_draws():
    """The reference's RANSAC draws in the port, the reference's gather
    remap in the reference (a band taller than its cap)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rigid, "hypothesis_indices", _jax_samples)
        mp.setattr(jrectify, "vertical_band", lambda remap: 10**9)
        yield


def _bench_config():
    """The bench's runtime (window BA on every keyframe, VO scalars not
    synced per frame) with the product estimator, on the small rig."""
    cfg = _config()
    return cfg.replace(ba=_PRODUCT_BA, runtime=dataclasses.replace(
        cfg.runtime, ba_every_keyframe=True, sync_metrics=False))


@pytest.fixture(scope="module")
def setup(sequence):
    rig, _ = sequence
    return ("cpu", (H, W, 32), port(rig), None, port(_bench_config()), N_WARMUP, N_TIMED)


@pytest.fixture(scope="module")
def runs(sequence, setup):
    """{pre_upload: (reference result, port result)}."""
    rig, frames = sequence
    out = {}
    for pre in (False, True):
        _, want = jbench._run_engine(_bench_config(), rig, frames, N_WARMUP, N_TIMED, pre)
        _, got = bench._run_engine(setup[4], setup[2], port(frames), N_WARMUP, N_TIMED,
                                   pre, device="cpu")
        out[pre] = want, got
    return out


@pytest.mark.parametrize("pre_upload", [False, True], ids=["streamed", "resident"])
def test_run_engine_matches_reference(runs, pre_upload):
    want, got = runs[pre_upload]
    np.testing.assert_array_equal(got.keyframe_indices, want.keyframe_indices)
    assert len(got.keyframe_indices) >= 4
    assert got.trajectory.shape == want.trajectory.shape == (N_WARMUP + N_TIMED, 4, 4)
    dt = np.linalg.norm(got.trajectory[:, :3, 3] - want.trajectory[:, :3, 3], axis=1)
    assert dt.max() < 1e-3, dt
    assert _angle(got.trajectory, want.trajectory).max() < 1e-3
    assert abs(len(got.map_points) - len(want.map_points)) <= 0.005 * len(want.map_points)
    assert got.metrics["warmup_frames_excluded"] == N_WARMUP
    assert set(got.metrics) >= {"t_step_ms", "t_fusion_ms", "t_ba_ms"}


def test_streamed_and_resident_runs_agree(runs):
    """The prefetcher's worker packs the same bytes the resident run
    uploads first: the same trajectory, bit for bit, and the same map."""
    streamed, resident = runs[False][1], runs[True][1]
    np.testing.assert_array_equal(streamed.trajectory, resident.trajectory)
    np.testing.assert_array_equal(streamed.keyframe_indices, resident.keyframe_indices)
    assert len(streamed.map_points) == len(resident.map_points)


@pytest.fixture(scope="module")
def bench_main(sequence, setup, tmp_path_factory):
    """(stdout lines, detail file, returned detail) of ``main`` on the CPU."""
    import contextlib
    import io

    _, frames = sequence
    detail_path = tmp_path_factory.mktemp("bench") / "detail.json"
    before = (ROOT / "BENCH_DETAIL.json").read_bytes()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "KERNEL_SHAPES", SMALL_KERNELS)
        detail = bench.main(["--device", "cpu", "--detail", str(detail_path)], setup=setup,
                            frames=port(frames))
    assert (ROOT / "BENCH_DETAIL.json").read_bytes() == before
    with open(detail_path) as fh:
        return buf.getvalue().splitlines(), json.load(fh), detail


def test_main_prints_the_reference_line_and_detail(bench_main):
    lines, written, detail = bench_main
    assert len(lines) == 1
    line = json.loads(lines[0])
    metric = re.findall(r'"metric": "([^"]+)"', (ROOT / "bench.py").read_text())
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert [line["metric"]] == sorted(set(metric)) and line["unit"] == "frames/s"
    assert line["value"] > 0 and line["vs_baseline"] == round(line["value"] / 10.0, 3)
    with open(ROOT / "BENCH_DETAIL.json") as fh:
        reference = json.load(fh)
    assert set(written) == set(reference) | {"device"}
    assert written == json.loads(json.dumps(detail))
    for key in ("frame_attribution_ms", "ate_m"):
        assert set(written[key]) == set(reference[key]), key
    assert set(written["kernels"]) == set(reference["kernels"]) - {"sgm_aggregation"}
    assert written["device"] == {"name": "cpu", "power_limit": None,
                                 "torch": torch.__version__, "cuda": torch.version.cuda}
    assert written["backend"] == "cpu" and written["resolution"] == f"{W}x{H}x32"
    assert written["frames_timed"] == N_TIMED
    assert set(written["stage_means_ms"]) >= {"t_step_ms", "t_fusion_ms", "t_ba_ms"}
    ate = written["ate_m"]
    assert ate["full_stack"] < ate["prior_only_dead_reckoning"]
    assert written["frame_attribution_ms"]["upload_bytes_per_frame"] == (
        80 + 2 * H * W + 3 * (H // 4) * (W // 4))


def test_kernel_rows_count_the_reference_models(bench_main):
    """Bytes and arithmetic intensity of every row equal the reference's
    work model at the same shapes (arithmetic, no JAX compile)."""
    kernels = bench_main[1]["kernels"]
    ka, kb = SMALL_KERNELS["matching"]
    w8, l8, n8 = SMALL_KERNELS["ba_schur"]
    w64, l64, k64 = SMALL_KERNELS["ba_schur_w64"]
    models = {"matching": jroofline.matching_model(ka, kb, 256, 1.0),
              "ba_schur": jroofline.ba_schur_model(w8, l8, n8, 5, 1.0),
              "ba_schur_w64": jroofline.ba_schur_model(w64, l64, w64 * k64, 5, 1.0)}
    for name, model in models.items():
        row = kernels[name]
        assert row["kernel"] == model.name, name
        assert row["bytes"] == model.bytes_accessed, name
        assert row["arithmetic_intensity"] == model.arithmetic_intensity, name
        assert row["time_ms"] > 0, name
    for name in ("ba_schur", "ba_schur_w64"):
        assert kernels[name]["ba_iters_per_s"] == pytest.approx(
            5e3 / kernels[name]["time_ms"])


def test_no_card_prints_the_zero_line_and_exits_1(tmp_path):
    detail = tmp_path / "detail.json"
    proc = subprocess.run(
        [sys.executable, "-m", "online_3d_reconstruction_tpu_torch.bench", "--device", "cuda",
         "--detail", str(detail)], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"metric": bench.METRIC, "value": 0.0, "unit": "frames/s",
                                    "vs_baseline": 0.0}
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not detail.exists()


@pytest.mark.parametrize("entry", ["bench", "profile_steady", "profile_stage_parts"])
def test_entry_refuses_cuda_without_card(entry, monkeypatch):
    """The default device is the card: without one each entry raises
    before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"bench": lambda: bench.main([]),
            "profile_steady": lambda: profile_steady.main([]),
            "profile_stage_parts": lambda: profile_stage_parts.main(8, 8, 4)}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def _steady_reference_rows(cfg):
    """The reference tool's row names, its f-strings filled in from the
    configuration."""
    source = (ROOT / "tools" / "profile_steady.py").read_text()
    names = re.findall(r'report\(f?"([^"]+)"', source)
    names += re.findall(r'\("(FUSED [^"]+)", steady', source)
    assert len(names) == 7, names
    scope = dict(ds_every=cfg.mapping.downsample_every, wt=cfg.ba.window,
                 lt=cfg.ba.max_landmarks, cfg=cfg)
    return [eval("f" + repr(name), {}, scope) for name in names]


def test_profile_steady_prints_every_reference_row(sequence, setup, capsys):
    _, frames = sequence
    rows = profile_steady.main(device="cpu", setup=setup, frames=port(frames))
    want = _steady_reference_rows(setup[4])
    assert len(rows) == len(want)
    for (name, ms), ref in zip(rows, want):
        assert name == ref or name.startswith(ref + " [port: "), (name, ref)
        assert ms > 0, name
    printed = capsys.readouterr().out.splitlines()
    assert printed[:3] == ["device: cpu (cpu)", "rendered", "warm engine ready"]
    assert len(printed) == 3 + len(rows)
    assert all(line.startswith(name) for line, (name, _) in zip(printed[3:], rows))


def test_profile_steady_leaves_the_engine_as_it_was(sequence, setup, capsys):
    """After the timing, the engine's next frames equal an unprofiled
    engine's: records, poses, staging pool, main pool and BA window (the
    timed frames include keyframes, so the window slides)."""
    _, frames = sequence
    frames = port(frames)
    cfg, rig = setup[4], setup[2]
    engines = [OnlineReconstructor(cfg, rig, "cpu") for _ in range(2)]
    for engine in engines:
        for f in frames[:N_WARMUP]:
            engine.process(f)
    profile_steady.steady_rows(engines[0], frames[N_WARMUP], N_WARMUP)
    records = [[e.process(f) for f in frames[N_WARMUP:]] for e in engines]
    assert any(r["keyframe"] for r in records[0])

    def untimed(rows):
        return [{k: v for k, v in r.items() if not k.startswith("t_")} for r in rows]

    assert untimed(records[0]) == untimed(records[1])
    profiled, plain = engines
    np.testing.assert_array_equal(profiled.trajectory_numpy(), plain.trajectory_numpy())
    for pool in ("_staging", "gmap"):
        for a, b in zip(getattr(profiled, pool), getattr(plain, pool)):
            assert torch.equal(a, b), pool
    for a, b in zip(profiled._ba_state[:-1], plain._ba_state[:-1]):
        assert torch.equal(a, b)
    assert profiled._ba_state.count == plain._ba_state.count


def test_profile_stage_parts_prints_every_reference_row(capsys):
    rows = profile_stage_parts.main(48, 64, 16, device="cpu")
    source = (ROOT / "tools" / "profile_stage_parts.py").read_text()
    want = re.findall(r'print\(f"(.+?): \{sec', source)
    assert len(want) == 8, want
    names = [name for name, _ in rows]
    assert all(ms > 0 for _, ms in rows)
    # every reference row, in order, under its name or its name and the port's form
    ported = [n for n in names if any(n == r or n.startswith(r + " [port: ") for r in want)]
    assert len(ported) == len(want)
    for name, ref in zip(ported, want):
        assert name == ref or name.startswith(ref + " [port: "), (name, ref)
    assert [n for n in names if n not in ported] == [
        "census x2 + cost_volume -> uint8 (port only) [port: plain chain]",
        "lr_consistency (gather form, port only) [port: lr_consistency_mask]"]
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("device: cpu")
    assert [line.rsplit(": ", 1)[0] for line in printed[1:]] == names
