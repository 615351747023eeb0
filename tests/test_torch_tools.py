"""PyTorch port, profiling: ``tools.profile_stages`` prints every row of the
reference tool (tools/profile_stages.py) under the same names, here at a
tiny size on the CPU, ``tools.profile_sgm`` its rows, ``utils.roofline``'s
timing helpers, its work models and ``RooflinePoint.report`` against the
reference's arithmetic, and ``tools.scaling_bench`` on one and two CPU
ranks."""

import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.utils import roofline as jroofline
from online_3d_reconstruction_tpu_torch.tools import profile_sgm, profile_stages, scaling_bench
from online_3d_reconstruction_tpu_torch.utils import roofline

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _reference_rows():
    source = (ROOT / "tools" / "profile_stages.py").read_text()
    names = re.findall(r'bench\(\s*"([^"]+)"', source)
    assert len(names) == 14, names
    return names + ["TOTAL (sum of stages)"]


def test_profile_stages_prints_every_reference_row(capsys):
    """The reference's rows in its order and its total, beside them the
    port's own rows (the plain census chain, the bf16 aggregation), which
    the total leaves out."""
    rows = profile_stages.main(48, 64, 16, device="cpu")
    want = _reference_rows()
    port_only = [name for name, _ in rows if name.endswith(profile_stages.PORT_ONLY)]
    assert port_only == ["census(5x5) x2 + cost_volume [port: plain chain]"
                         + profile_stages.PORT_ONLY,
                         "sgm aggregate 8-path bf16" + profile_stages.PORT_ONLY]
    assert [name for name, _ in rows if name not in port_only] == want
    assert all(ms > 0 for _, ms in rows)
    assert abs(rows[-1][1] - sum(ms for name, ms in rows[:-1] if name not in port_only)) < 1e-6
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("device: cpu")
    assert [line[:32].rstrip() for line in printed[1:]
            if not line.startswith(tuple(port_only))] == want


def test_profile_sgm_prints_every_row(capsys):
    """Per storage dtype the reference tool's scan rows (vertical,
    horizontal, diagonal, skew alone) and the two passes alone, then K1's 8-
    and 4-path rows; a scan row carries its effective GB/s."""
    rows = profile_sgm.main(24, 32, 16, device="cpu")
    per_dtype = ["vertical scan_pair", "vertical forward pass alone",
                 "vertical backward pass alone", "horizontal (swap+scan+swap)",
                 "diagonal (skew+scan+deskew)", "skew alone"]
    want = [f"[{tag}] {row}" for tag in ("f32", "bf16") for row in per_dtype]
    want += ["FULL aggregate 8-path", "FULL aggregate 4-path"]
    assert [name for name, _ in rows] == want
    assert all(ms > 0 for _, ms in rows)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("device: cpu")
    assert [line[:40].rstrip() for line in printed[1:]] == want
    assert sum("GB/s eff" in line for line in printed) == 6
    reference = (ROOT / "tools" / "profile_sgm.py").read_text()
    for row in ("vertical scan_pair", "horizontal (swap+scan+swap)",
                "diagonal (skew+scan+deskew)", "skew alone"):
        assert row in reference, row


def test_measure_times_the_host_clock_on_cpu():
    x = torch.zeros(4)
    assert roofline._device((x,)) == torch.device("cpu")
    assert roofline._device(((1, [x]),)) == torch.device("cpu")
    assert roofline._device((1.0,)) is None
    calls = []

    def work(t):
        calls.append(t)
        time.sleep(0.002)

    per_call = roofline.measure_amortized(work, (x,), inner=3, n=2)
    assert len(calls) == 1 + 3 * 2
    assert 0.002 <= per_call < 0.05
    assert 0.002 <= roofline.measure(work, (x,), n=3) < 0.05
    assert len(calls) == 7 + 1 + 3


_MODELS = [("sgm_aggregation_model", (384, 512, 64, 8, 1.57e-4)),
           ("sgm_aggregation_model", (96, 128, 16, 4, 2e-5, 4)),
           ("matching_model", (512, 512, 256, 4.77e-4)),
           ("ba_schur_model", (64, 2048, 32768, 3, 1.8e-2)),
           ("ba_schur_model", (8, 256, 2048, 5, 1e-3)),
           ("voxel_model", (2_000_000, 8.6e-3)),
           ("voxel_model", (1, 1e-6))]
# the port's names for the reference's roofs and report entries
_ROOFS = {"hbm_gbps": "hbm_gbps", "tensor_tflops_bf16": "mxu_tflops_bf16",
          "cuda_core_tops_f32": "vpu_tops_f32"}
_REPORT = {"achieved_tensor_tflops": "achieved_mxu_tflops",
           "achieved_cuda_core_tops": "achieved_vpu_tops",
           "pct_tensor_peak": "pct_mxu_peak", "pct_cuda_core_peak": "pct_vpu_peak"}
_ROOF_NAMES = {"hbm": "hbm", "tensor": "mxu", "cuda_core": "vpu"}


@pytest.mark.parametrize("model,args", _MODELS,
                         ids=[f"{m}-{a[0]}" for m, a in _MODELS])
def test_roofline_models_and_report_match_reference(model, args):
    """The work models are arithmetic: bytes, FLOPs, operations and name
    equal to the reference's on the same arguments (exact); ``report`` with
    the same peak values passed in gives the same numbers under the port's
    names for the roofs."""
    want = getattr(jroofline, model)(*args)
    got = getattr(roofline, model)(*args)
    for field in ("name", "bytes_accessed", "flops", "vector_ops", "seconds"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.arithmetic_intensity == want.arithmetic_intensity
    peaks = {"hbm_gbps": 1234.0, "mxu_tflops_bf16": 210.0, "vpu_tops_f32": 55.5}
    want_r = want.report(peaks)
    got_r = got.report({k: peaks[v] for k, v in _ROOFS.items()})
    assert "invalid" not in want_r
    assert _ROOF_NAMES[got_r["binding_roof"]] == want_r["binding_roof"]
    for key, value in got_r.items():
        if key not in ("binding_roof", "notes"):
            assert value == want_r[_REPORT.get(key, key)], key
    assert set(got_r) == {k for k in want_r if k not in _REPORT.values()} | set(_REPORT)


def test_roofline_report_invalid_cases_and_h100_peaks():
    """The two refusals of the reference's ``report`` (no resolvable time;
    above a roof), and the H100's published peaks as the default table."""
    for seconds in (float("nan"), 0.0):
        got = roofline.sgm_aggregation_model(8, 8, 8, 2, seconds).report()
        want = jroofline.sgm_aggregation_model(8, 8, 8, 2, seconds).report()
        assert got["invalid"] == want["invalid"] and "time_ms" not in got
    got = roofline.voxel_model(10**9, 1e-6).report()
    want = jroofline.voxel_model(10**9, 1e-6).report(
        {_ROOFS[k]: v for k, v in roofline.H100_PEAKS.items()})
    assert got["invalid"].startswith("measured") and "impossible" in got["invalid"]
    assert got["invalid"] == want["invalid"] and got["time_ms"] == want["time_ms"]
    assert roofline.H100_PEAKS == {"hbm_gbps": 3350.0, "tensor_tflops_bf16": 989.0,
                                   "cuda_core_tops_f32": 67.0}
    ok = roofline.sgm_aggregation_model(384, 512, 64, 8, 1.57e-4).report()
    assert ok["binding_roof"] == "cuda_core" and 0 < ok["pct_of_binding_roof"] < 100


def test_scaling_bench_small_on_one_and_two_ranks(tmp_path, capsys):
    """The analytic table at n = 1, 2, 4, 8 and the wall-clock of every
    stage on one and two CPU gloo ranks, labelled so; the two rank counts
    agree (solve cost traces to 1e-4, the voxel count and the dropped count
    exactly, the valid share of the slab SGM within 0.01)."""
    out = tmp_path / "scaling.json"
    result = scaling_bench.main(["--small", "--wall", "1", "2", "--output", str(out)])
    printed = capsys.readouterr().out
    assert "cpu_gloo: not a GPU time" in printed and "analytic" in printed
    stages = result["stages"]
    assert len(stages) == 4 and all(s["bytes_per_call"] > 0 for s in stages)
    assert [sorted(s["work_per_rank"]) for s in stages] == [[1, 2, 4, 8]] * 4
    assert stages[0]["work_per_rank"][4] == {"observations": 128}
    # the reference tool's byte counts at its own shapes
    full = scaling_bench.analytic(scaling_bench.FULL)
    assert full[0]["bytes_per_call"] == 4 * (64 * 36 + 512 * 9 + 64 * 512 * 18 + 64 * 6 + 512 * 3)
    assert full[1]["bytes_per_call"] == 4 * (64 * 42 + 64 * 2048 * 18) + 4 * 2048 * 12
    assert full[2]["bytes_per_call"] == 8_000_000 * 36
    assert full[3]["bytes_per_call"] == 2 * 2 * 34 * 1024 * 4
    wall = result["cpu_gloo"]
    assert set(wall["seconds"]) == {"ba", "slots", "voxel", "sgm"}
    for stage, row in wall["seconds"].items():
        assert set(row) == {1, 2} and all(t > 0 for t in row.values()), stage
    d = wall["digests"]
    for stage in ("ba", "slots"):
        np.testing.assert_allclose(d[stage][2], d[stage][1], rtol=1e-4)
    assert d["voxel"][1] == d["voxel"][2] and d["voxel"][1][1] == 0
    assert abs(d["sgm"][1][0] - d["sgm"][2][0]) < 0.01
    assert out.exists()
