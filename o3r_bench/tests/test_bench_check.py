"""The comparison that decides ``correct``, driven through a whole run at a
small size on the CPU (the harness's look for a card skipped): sound runs
pass, the lower-precision control fails, and each fault the cells can have,
planted under the timed path, fails."""

import time

import pytest
import torch

from online_3d_reconstruction_tpu_torch.ba import device_tracks
from online_3d_reconstruction_tpu_torch.runtime import pipeline

from o3r_bench.check import judge
from o3r_bench.harness import run_cell
from o3r_bench.tests.conftest import small


def _run(which, patch=None, controls=False, seed=2**31 + 11, trace=False):
    torch.set_num_threads(4)
    doc, mix = small(which)
    return run_cell(doc, mix, seed, 2.0, trace, "cpu", t_start=time.perf_counter(),
                    controls=controls, patch=patch)


@pytest.mark.parametrize("which", ["survey", "euroc"])
def test_sound_run_passes_and_control_fails(which):
    out = _run(which, controls=True, trace=True)
    assert out["correct"], out["numbers"]
    assert all(v == 0.0 for v in out["numbers"].values()), out["numbers"]
    # the control: SGM stored in fp8 where the configuration states bfloat16
    assert not judge(out["control_numbers"], out["limits"]), out["control_numbers"]
    assert out["summary"]["frames"] == 3 and out["frames"] >= 4


def _stale_window(monkeypatch):
    """A BA event that appends the keyframe and returns the window unsolved."""
    def stale(state, points3d, valid3d, match_idx, match_ok, pose, prior, cfg, mesh=None,
              noise_model=None):
        new = device_tracks._append(state, points3d, valid3d, match_idx, match_ok, pose,
                                    prior)
        return new, new.poses, {}
    monkeypatch.setattr(pipeline, "keyframe_core", stale)


def _half_image(engine):
    """The disparity stage computes the upper half of the image only."""
    compute = engine._compute_disparity

    def half(left_r, right_r):
        disp = compute(left_r, right_r).clone()
        disp[disp.shape[0] // 2:] = engine.cfg.stereo.invalid_value
        return disp
    engine._compute_disparity = half


def _moved_pose(engine):
    """Each steady frame's pose comes out 2 cm off where the step makes it."""
    step = engine._steady_step

    def moved(*args, **kwargs):
        pose, *rest = step(*args, **kwargs)
        pose = pose.clone()
        pose[0, 3] += 0.02
        return (pose, *rest)
    engine._steady_step = moved


@pytest.mark.parametrize("fault", ["state_unchanged", "half_image", "answer_altered"])
def test_planted_fault_fails(fault, monkeypatch):
    patch = None
    if fault == "state_unchanged":
        _stale_window(monkeypatch)
    else:
        patch = {"half_image": _half_image, "answer_altered": _moved_pose}[fault]
    out = _run("survey", patch=patch)
    assert not out["correct"], out["numbers"]


@pytest.mark.card
def test_cells_on_the_card(card):
    """One short run of each cell on the card, at its own size: correct, and
    the control not."""
    import json
    from o3r_bench.run import load_cell

    for name in ("survey.flat_out", "euroc.sensor_20hz"):
        _, _, doc, mix = load_cell(name)
        out = run_cell(doc, mix, 3_000_000_019, 4.0, False, card,
                       t_start=time.perf_counter(), controls=True)
        assert out["correct"], (name, out["numbers"])
        assert not judge(out["control_numbers"], out["limits"]), (name, json.dumps(
            out["control_numbers"]))
