"""Shared pieces of the benchmark's tests: the ``card`` marker and fixture
(a test that needs a CUDA card skips without one, decided inside the
fixture), and the cells' configurations cut to a size the CPU runs."""

import copy
import json
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's runs measure the port on it")
    return torch.device("cuda")


def small(which: str, h: int = 192, w: int = 256):
    """(configuration, mix) of a cell at h x w, D=32, 256 keypoints, a
    window of 4: the same stages at a size the CPU runs in seconds."""
    name, mix = {"survey": ("survey_512x384_d64", "flat_out"),
                 "euroc": ("euroc_752x480_d64", "sensor_20hz")}[which]
    doc = copy.deepcopy(json.loads((PKG / "configs" / f"{name}.json").read_text()))
    for side in ("left", "right"):
        c = doc["sensor"][side]
        sx, sy = w / c["width"], h / c["height"]
        c.update(fx=c["fx"] * sx, fy=c["fy"] * sy, cx=c["cx"] * sx, cy=c["cy"] * sy,
                 width=w, height=h)
    p = doc["pipeline"]
    p["stereo"].update(height=h, width=w, max_disparity=32)
    p["features"].update(max_keypoints=256)
    p["ba"].update(window=4, max_landmarks=512)
    p["mapping"].update(map_capacity=400000)
    mix = json.loads((PKG / "traffic" / f"{mix}.json").read_text())
    mix.update(warmup_frames=6, trace_frames=3)
    if mix["loop"] == "open":
        mix["rate_hz"] = 2.0
    return doc, mix
