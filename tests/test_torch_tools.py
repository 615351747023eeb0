"""PyTorch port, profiling: ``tools.profile_stages`` prints every row of the
reference tool (tools/profile_stages.py) under the same names, here at a
tiny size on the CPU, ``tools.profile_sgm`` its rows, and
``utils.roofline``'s timing helpers."""

import re
import time
from pathlib import Path

import torch

from online_3d_reconstruction_tpu_torch.tools import profile_sgm, profile_stages
from online_3d_reconstruction_tpu_torch.utils import roofline

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _reference_rows():
    source = (ROOT / "tools" / "profile_stages.py").read_text()
    names = re.findall(r'bench\(\s*"([^"]+)"', source)
    assert len(names) == 14, names
    return names + ["TOTAL (sum of stages)"]


def test_profile_stages_prints_every_reference_row(capsys):
    rows = profile_stages.main(48, 64, 16, device="cpu")
    want = _reference_rows()
    assert [name for name, _ in rows] == want
    assert all(ms > 0 for _, ms in rows)
    assert abs(rows[-1][1] - sum(ms for _, ms in rows[:-1])) < 1e-6
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("device: cpu")
    assert [line[:32].rstrip() for line in printed[1:]] == want


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
