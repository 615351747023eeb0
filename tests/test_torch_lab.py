"""PyTorch port, the estimator and solver lab (``tools.lab_scene`` and the
nine tools beside it), on the CPU at small sizes: the lab scene against the
objects the reference tools build, every tool's printed rows against the
reference source's, and each tool's numbers against the JAX package on the
same numpy frames (the reference's portable path: ``use_pallas=False``,
``cost_dtype=float32``)."""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu import config as jconfig
from online_3d_reconstruction_tpu.ba.device_tracks import build_problem as jbuild_problem
from online_3d_reconstruction_tpu.features.fast import detect_keypoints as jdetect_keypoints
from online_3d_reconstruction_tpu.io import calibration as jcal
from online_3d_reconstruction_tpu.io import synthetic as jsyn
from online_3d_reconstruction_tpu.io.dataset import SyntheticSequence as JSequence
from online_3d_reconstruction_tpu.runtime import pipeline as jpipe
from online_3d_reconstruction_tpu.stereo.sgm import sgm_disparity as jsgm_disparity
from online_3d_reconstruction_tpu.utils.metrics import ate_rmse
from online_3d_reconstruction_tpu_torch import config as tconfig
from online_3d_reconstruction_tpu_torch.ba.device_tracks import build_problem, window_from_numpy
from online_3d_reconstruction_tpu_torch.tools import (
    ate_diag,
    ate_lab,
    ba_bias,
    ba_scale,
    bias_vs_edge,
    lab_scene,
    profile_ba64,
    profile_match,
    sgm_cache,
    vo_link_err,
)
from scipy.ndimage import distance_transform_edt
from tests.test_torch_shared import _assert_same, port
from tools import ate_diag as jate_diag

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--size", "96", "128", "16"]
SMALL = (192, 256, 32)          # the size of the runs held against JAX
SMALL_ARGS = ["--device", "cpu", "--size", *map(str, SMALL)]


# ---------------------------------------------------------------------------
# the reference tools' scene block (tools/ate_lab.py:67-134), at any size
# ---------------------------------------------------------------------------

def _jax_sequence(n, size=lab_scene.SIZE, supersample=2, distorted=False):
    h, w = size[:2]
    fx = 400.0 * w / 512.0
    calib = None
    if distorted:
        cam = jcal.CameraIntrinsics(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h,
                                    dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
        calib = jcal.StereoCalibration(left=cam, right=cam,
                                       translation=np.array([-0.5, 0.0, 0.0]))
        rig = jcal.stereo_rectify(calib)
    else:
        rig = jcal.identity_rig(fx=fx, fy=fx, cx=w / 2, cy=h / 2, baseline=0.5,
                                width=w, height=h)
    scene = jsyn.SyntheticScene(seed=5, plateaus=[jsyn.Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                                supersample=supersample)
    poses = jsyn.make_survey_trajectory(n, altitude=30.0, speed=1.2)
    return JSequence(scene=scene, rig=rig, poses=poses, prior_translation_sigma=0.15,
                     prior_rotation_sigma=0.01, calib=calib)


def _jax_config(size=lab_scene.SIZE, ba=None, **runtime):
    h, w, d = size
    return jconfig.PipelineConfig(
        stereo=jconfig.StereoConfig(height=h, width=w, max_disparity=d, num_paths=8,
                                    use_pallas=False, cost_dtype="float32"),
        features=jconfig.FeatureConfig(max_keypoints=512, fast_threshold=5.0),
        odometry=jconfig.OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        ba=ba or jconfig.BAConfig(prior_position_weight=1.0 / 0.15**2,
                                  prior_rotation_weight=1.0 / 0.01**2),
        mapping=jconfig.MappingConfig(voxel_size=0.25, map_capacity=2_000_000,
                                      frame_point_stride=2, min_depth=1.0, max_depth=60.0),
        runtime=jconfig.RuntimeConfig(keyframe_translation=0.5, **runtime),
    )


@pytest.mark.parametrize("distorted", [False, True], ids=["identity", "distorted"])
def test_lab_scene_equals_reference_objects(distorted):
    """Rig, poses, priors and the base configuration at the tools' full size
    equal what tools/ate_lab.py builds (nothing is rendered); the stereo
    section's ``use_pallas`` / ``cost_dtype`` are the reference's own
    matter."""
    want = _jax_sequence(7, distorted=distorted)
    got = lab_scene.make_sequence(7, distorted=distorted)
    _assert_same(vars(got.rig), vars(port(want.rig)), "rig")
    assert (got.calib is None) == (not distorted)
    _assert_same(list(got.poses), list(want.poses), "poses")
    _assert_same(got._priors, want._priors, "priors")
    assert dataclasses.asdict(got.scene) == dataclasses.asdict(want.scene)
    runtime = dict(sync_metrics=False, use_precomputed_disparity=True)
    got_cfg = tconfig.config_to_dict(lab_scene.base_config(**runtime))
    want_cfg = jconfig.config_to_dict(_jax_config(**runtime))
    for key in ("use_pallas", "cost_dtype"):
        got_cfg["stereo"].pop(key), want_cfg["stereo"].pop(key)
    assert got_cfg == want_cfg
    # another size: the same view through a scaled focal length
    small = lab_scene.make_sequence(3, SMALL, supersample=1)
    assert (small.rig.fx, small.rig.width, small.rig.height) == (200.0, 256, 192)


def test_ate_lab_variants_are_the_reference_sweep():
    """The ten named variants, in the reference's order, with the settings
    their names state over the shared base (3-sigma huber, noise model on)."""
    source = (ROOT / "tools" / "ate_lab.py").read_text()
    names = re.findall(r'^\s+"(w [^"]+)": dataclasses\.replace', source, re.M)
    sweep = ate_lab.variants(tconfig.BAConfig())
    assert len(names) == 10 and list(sweep) == names
    default = tconfig.BAConfig()
    for name, ba in sweep.items():
        assert ba.obs_weighting and ba.huber_delta == 3.0 and ba.sigma_pixel == 0.5
        w = re.search(r"W(\d+) L(\d+)", name)
        window, landmarks = ((int(w[1]), int(w[2])) if "bench" not in name
                             else (default.window, default.max_landmarks))
        assert (ba.window, ba.max_landmarks) == (window, landmarks), name
        d = re.search(r" d([\d.]+)", name)
        assert ba.sigma_disparity == (float(d[1]) if d else 0.5), name
        assert ba.gn_iters == default.gn_iters   # "gn3" names the default
    with pytest.raises(SystemExit, match="unknown variants"):
        ate_lab.main(TINY + ["--variants", "w W99"])


# ---------------------------------------------------------------------------
# every tool runs on the CPU and prints the reference tool's rows
# ---------------------------------------------------------------------------

def _reference_texts(tool):
    """The fixed text of every ``print(`` / ``report(`` of a reference tool:
    its leading string literals (adjacent ones joined), cut at the
    placeholders (a column header's ``{'name':>3}`` counts as its name),
    pieces of four characters or more. ``backend:`` is left out: the port
    prints ``device:`` there."""
    source = (ROOT / "tools" / tool).read_text()
    one = r'f?"(?:[^"\\]|\\.)*"'
    texts = []
    for literals in re.findall(rf'(?:print|report)\(\s*((?:{one}\s*)+)', source):
        literal = "".join(re.findall(r'f?"((?:[^"\\]|\\.)*)"', literals))
        literal = re.sub(r"\{'([^']+)'[^}]*\}", r"\1", literal.replace("\\n", " "))
        for piece in re.split(r"\{[^{}]*\}", literal):
            piece = " ".join(piece.split())
            if len(piece) >= 4 and piece != "backend:":
                texts.append(piece)
    return texts


_TOOLS = {
    "sgm_cache": ("sgm_cache_tpu.py", lambda tmp: sgm_cache.main(
        TINY + ["--frames", "2", "--out", str(tmp / "cache.npz")])),
    "bias_vs_edge": ("bias_vs_edge.py", lambda tmp: (
        sgm_cache.main(TINY + ["--frames", "2", "--out", str(tmp / "cache.npz")]),
        bias_vs_edge.main([str(tmp / "cache.npz")] + TINY))),
    "ate_lab": ("ate_lab.py", lambda tmp: ate_lab.main(
        TINY + ["--frames", "4", "--variants", "w bench W8 L512"])),
    "ate_diag": ("ate_diag.py", lambda tmp: ate_diag.main(TINY + ["--frames", "4"])),
    "vo_link_err": ("vo_link_err.py", lambda tmp: vo_link_err.main(TINY + ["--frames", "4"])),
    "ba_bias": ("ba_bias.py", lambda tmp: ba_bias.main(TINY + ["--frames", "4"])),
    "profile_match": ("profile_match.py", lambda tmp: profile_match.main(["--device", "cpu"])),
    # 64 keyframes, so that the 384x384 rows carry the reference's names
    "profile_ba64": ("profile_ba64.py", lambda tmp: profile_ba64.main(
        ["--device", "cpu", "--w", "64", "--l", "128", "--k", "32"])),
    "ba_scale": ("ba_scale.py", lambda tmp: ba_scale.main(
        ["--device", "cpu", "--w", "8", "16", "--iters", "2",
         "--json", str(tmp / "scale.json")])),
}


@pytest.mark.parametrize("tool", sorted(_TOOLS))
def test_tool_runs_on_cpu_and_prints_reference_rows(tool, tmp_path, capsys):
    reference, run = _TOOLS[tool]
    run(tmp_path)
    printed = " ".join(capsys.readouterr().out.split())
    want = _reference_texts(reference)
    assert len(want) >= 3, want
    missing = [text for text in want if text not in printed]
    assert not missing, (missing, printed)
    if tool == "ate_lab":
        assert "w bench W8 L512" in printed and "w W24" not in printed
    if tool == "ba_scale":
        assert "written:" in printed and (tmp_path / "scale.json").exists()
    if tool.startswith("profile") or tool == "ba_scale":
        assert "device: cpu" in printed and "backend" not in printed


@pytest.mark.parametrize("tool", sorted(_TOOLS))
def test_tool_refuses_cuda_without_card(tool, monkeypatch):
    """Every tool's default device is the card: without one it raises, as
    ``resolve_device`` does, and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = globals()[tool]
    argv = ["missing.npz"] if tool == "bias_vs_edge" else []
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(argv)


def test_profile_ba64_parts_cover_one_step():
    """The rows named as the parts of a step are rows of the tool, and their
    weighted sum is within a factor 3 of the one-iteration solve on this
    shared CPU (a part that times nothing would show here; on the card the
    smoke run holds it to a factor 2)."""
    rows = dict(profile_ba64.main(["--device", "cpu", "--w", "16", "--l", "256",
                                   "--k", "64"]))
    parts = sum(count * rows[name] for name, count in profile_ba64.STEP_PARTS)
    assert 1 / 3 <= parts / rows[profile_ba64.ONE_STEP] <= 3.0, rows
    assert all(sec > 0 for sec in rows.values())


# ---------------------------------------------------------------------------
# numbers against the JAX package on the same frames
# ---------------------------------------------------------------------------

def _jax_keypoint_pixels(left, h, w):
    kxy, _, kok = jdetect_keypoints(jnp.asarray(left), max_keypoints=512,
                                    threshold=5.0 / 255.0, subpixel=True)
    kxy = np.asarray(kxy)[np.asarray(kok)]
    return (np.clip(np.round(kxy[:, 0]).astype(int), 0, w - 1),
            np.clip(np.round(kxy[:, 1]).astype(int), 0, h - 1))


@pytest.fixture(scope="module")
def tiny_cache(tmp_path_factory):
    """``sgm_cache`` on 3 frames at 96x128x16, beside the reference's maps
    and keypoint error statistics on the same frames (the loop of
    tools/sgm_cache_tpu.py:103-141)."""
    size = (96, 128, 16)
    path = tmp_path_factory.mktemp("cache") / "cache.npz"
    got = sgm_cache.main(TINY + ["--frames", "3", "--out", str(path)])
    frames = list(_jax_sequence(3, size))
    scfg = _jax_config(size).stereo
    maps, stats = [], []
    for f in frames:
        dd = np.asarray(jsgm_disparity(jnp.asarray(f.left), jnp.asarray(f.right), scfg)[0])
        maps.append(dd)
        u, v = _jax_keypoint_pixels(f.left, *size[:2])
        ok = (dd[v, u] > 0) & (f.disparity[v, u] > 0)
        err = dd[v, u][ok] - f.disparity[v, u][ok]
        stats.append((err.mean(), np.sqrt((err**2).mean()), np.abs(err).mean(), ok.sum()))
    return path, got, frames, np.stack(maps), np.asarray(stats)


def test_sgm_cache_matches_jax(tiny_cache):
    """The cached maps equal the reference's ``sgm_disparity`` (integer
    costs: no tolerance); the per-frame keypoint error mean, rms and |err|
    within 1e-3 px, the keypoint counts equal."""
    path, got, _, want_maps, want_stats = tiny_cache
    np.testing.assert_array_equal(np.load(path)["disparity"], want_maps)
    np.testing.assert_array_equal(got["disparity"], want_maps)
    np.testing.assert_array_equal(got["stats"][:, 3], want_stats[:, 3])
    np.testing.assert_allclose(got["stats"][:, :3], want_stats[:, :3], atol=1e-3)
    assert got["sgm_s"] > 0 and got["render_s"] > 0


def test_bias_vs_edge_matches_jax(tiny_cache):
    """The four distance bins: the same n, mean and rms within 1e-3 px of the
    reference's binning (tools/bias_vs_edge.py:48-87) with its keypoints."""
    path, _, frames, maps, _ = tiny_cache
    rows = bias_vs_edge.main([str(path)] + TINY)
    assert [(lo, hi) for lo, hi, *_ in rows] == [(0, 3), (3, 6), (6, 12), (12, 1 << 30)]
    errs = {b[:2]: [] for b in rows}
    for f, dd in zip(frames, maps):
        gtd = f.disparity
        u, v = _jax_keypoint_pixels(f.left, 96, 128)
        gx = np.abs(np.diff(gtd, axis=1, prepend=gtd[:, :1]))
        gy = np.abs(np.diff(gtd, axis=0, prepend=gtd[:1]))
        dist = distance_transform_edt(~(np.maximum(gx, gy) > 0.75))
        ok = (dd[v, u] > 0) & (gtd[v, u] > 0)
        for lo, hi in errs:
            sel = ok & (dist[v, u] >= lo) & (dist[v, u] < hi)
            errs[(lo, hi)].append((dd[v, u] - gtd[v, u])[sel])
    assert sum(n for _, _, n, _, _ in rows) > 100
    for lo, hi, n, mean, rms in rows:
        e = np.concatenate(errs[(lo, hi)])
        assert n == len(e)
        if n:
            assert abs(mean - e.mean()) < 1e-3 and abs(rms - np.sqrt((e**2).mean())) < 1e-3


@pytest.mark.parametrize("window,keyframes", [(3, None), (16, [0, 2, 3, 7, 9]), (2, [1, 4])])
def test_oracle_fuse_equals_reference(window, keyframes):
    rng = np.random.default_rng(4)
    gt = np.tile(np.eye(4), (12, 1, 1))
    gt[:, :3, 3] = rng.normal(0, 5, (12, 3))
    priors = gt.copy()
    priors[:, :3, 3] += rng.normal(0, 0.15, (12, 3))
    np.testing.assert_allclose(ate_diag.oracle_fuse(priors, gt, window, keyframes),
                               jate_diag.oracle_fuse(priors, gt, window, keyframes),
                               rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def small_frames():
    """8 frames of the lab survey at 192x256 without supersampling (the
    render of ``ate_diag`` and ``vo_link_err``), as the reference's frames."""
    return list(_jax_sequence(8, SMALL, supersample=1))


@pytest.fixture(scope="module")
def jax_offline_engine(small_frames):
    """The reference engine after the 8 frames in offline mode (exact
    disparity), the lab's base configuration, with per-frame records."""
    cfg = _jax_config(SMALL, sync_metrics=True, use_precomputed_disparity=True)
    engine = jpipe.OnlineReconstructor(cfg, _jax_sequence(1, SMALL).rig)
    records = [engine.process(f) for f in small_frames]
    state = engine._ba_state
    kf_idx = [k.index for k in engine.keyframes[-int(state.count):]]
    return cfg, state, kf_idx, records, engine.finish()


def _ba_bias_reference(problem, live, gt_slot):
    """tools/ba_bias.py:80-104, on a problem of numpy arrays."""
    obs_kf = np.clip(np.asarray(problem.obs_kf), 0, live - 1)
    obs_lm, obs_pt = np.asarray(problem.obs_lm), np.asarray(problem.obs_point)
    ok = np.asarray(problem.obs_valid)
    r_gt, t_gt = gt_slot[:, :3, :3], gt_slot[:, :3, 3]
    world = np.einsum("nij,nj->ni", r_gt[obs_kf], obs_pt) + t_gt[obs_kf]
    l_cap = problem.landmarks.shape[0]
    cnt = np.bincount(obs_lm[ok], minlength=l_cap).astype(np.float64)
    lm = np.zeros((l_cap, 3))
    for a in range(3):
        lm[:, a] = np.bincount(obs_lm[ok], weights=world[ok, a], minlength=l_cap)
    lm /= np.maximum(cnt, 1.0)[:, None]
    res = np.einsum("nji,nj->ni", r_gt[obs_kf], lm[obs_lm] - t_gt[obs_kf]) - obs_pt
    tl = cnt[cnt > 0].astype(int)
    return np.sqrt((res[ok]**2).mean(0)), dict(zip(*np.unique(tl, return_counts=True)))


def test_ba_bias_matches_jax_on_an_injected_window(small_frames, jax_offline_engine):
    """The reference's window state after 8 frames goes through both
    packages' ``build_problem`` (the port's via ``window_from_numpy``): the
    per-axis residual RMS at ground truth within 1e-5 m and the track-length
    histogram equal, the port's numbers from ``ba_bias``'s own function."""
    cfg, state, kf_idx, _, _ = jax_offline_engine
    live = int(state.count)
    gt_slot = np.stack([small_frames[i].gt_pose for i in kf_idx])
    jproblem, jstats = jbuild_problem(state, cfg.ba.max_landmarks)
    want_rms, want_hist = _ba_bias_reference(jproblem, live, gt_slot)
    problem, stats = build_problem(window_from_numpy(state, "cpu"), cfg.ba.max_landmarks)
    assert int(stats["landmarks"]) == int(jstats["landmarks"]) > 50
    assert int(stats["observations"]) == int(jstats["observations"])
    problem = type(problem)(*(None if v is None else v.numpy() for v in problem))
    res, ok, _, cnt = ba_bias.residuals_at_ground_truth(problem, live, gt_slot)
    np.testing.assert_allclose(np.sqrt((res[ok]**2).mean(0)), want_rms, atol=1e-5)
    tl = cnt[cnt > 0].astype(int)
    assert dict(zip(*np.unique(tl, return_counts=True))) == want_hist


def test_ate_lab_and_ate_diag_against_jax(small_frames, jax_offline_engine, capsys):
    """The port's own RANSAC draws, nothing injected: the ATE of the base
    configuration within the pipeline tests' bound against the reference's
    (<= 1.2x + 0.01 m), below dead reckoning; ``ate_diag``'s records carry
    ``used_vo`` and ``vo_inliers`` for every frame under the reference's
    keys, the same keyframes and the same oracle."""
    cfg, _, _, want_records, want = jax_offline_engine
    gt = np.stack([f.gt_pose for f in small_frames])
    ate_ref = ate_rmse(want.trajectory, gt)
    got = ate_diag.main(SMALL_ARGS + ["--frames", "8"], frames=port(small_frames))
    assert np.isfinite(got["ate_full"]) and got["ate_full"] <= 1.2 * ate_ref + 0.01
    assert got["ate_full"] < got["ate_prior"]
    assert [r[1] for r in got["rows"]] == [bool(r["keyframe"]) for r in want_records]
    assert [r[2] for r in got["rows"]] == [r["used_vo"] for r in want_records]
    assert all(isinstance(r[3], int) for r in got["rows"])
    assert sum(r[3] for r in got["rows"]) > 0
    kf = [k for k, r in enumerate(want_records) if r["keyframe"]]
    priors = np.stack([f.prior_pose for f in small_frames])
    assert abs(got["ate_oracle"] - ate_rmse(
        jate_diag.oracle_fuse(priors, gt, cfg.ba.window, kf), gt)) < 1e-9

    # the same frames through ate_lab's first variant against the reference
    # engine under that variant's settings
    ba = dataclasses.replace(cfg.ba, obs_weighting=True, huber_delta=3.0,
                             sigma_pixel=0.5, sigma_disparity=0.5)
    jcfg = _jax_config(SMALL, ba=ba, sync_metrics=False, use_precomputed_disparity=True)
    ate_ref = ate_rmse(jpipe.reconstruct(small_frames, jcfg,
                                         _jax_sequence(1, SMALL).rig).trajectory, gt)
    lab = ate_lab.main(SMALL_ARGS + ["--frames", "8", "--ss", "1", "--variants",
                                     "w bench W8 L512"], frames=port(small_frames))
    ate = lab["ate"]["w bench W8 L512"]
    assert abs(lab["prior"] - got["ate_prior"]) < 1e-9
    assert np.isfinite(ate) and ate <= 1.2 * ate_ref + 0.01 and ate < lab["prior"]
    assert f"{ate:.4f}" in capsys.readouterr().out


def test_vo_link_err_against_jax(small_frames):
    """Window BA off: the per-link RMS within the pipeline tests' bound of
    the reference's on the same frames (<= 1.2x + 0.01 m), the VO gate equal
    on every link."""
    cfg = _jax_config(SMALL, ba=jconfig.BAConfig(), sync_metrics=True,
                      ba_every_keyframe=False, host_ba=False,
                      use_precomputed_disparity=True)
    engine = jpipe.OnlineReconstructor(cfg, _jax_sequence(1, SMALL).rig)
    records = [engine.process(f) for f in small_frames]
    traj = engine.finish().trajectory
    gt = np.stack([f.gt_pose for f in small_frames])
    errs = []
    for k in range(1, len(gt)):
        rel_est = np.linalg.inv(traj[k - 1]) @ traj[k]
        rel_gt = np.linalg.inv(gt[k - 1]) @ gt[k]
        errs.append((np.linalg.inv(rel_gt) @ rel_est)[:3, 3])
    rms_ref = float(np.sqrt((np.asarray(errs)**2).sum(1).mean()))
    got = vo_link_err.main(SMALL_ARGS + ["--frames", "8"], frames=port(small_frames))
    assert got["link_errors"].shape == (7, 3) and np.isfinite(got["link_errors"]).all()
    assert got["used_vo"] == [r["used_vo"] for r in records[1:]]
    assert got["rms"] <= 1.2 * rms_ref + 0.01, (got["rms"], rms_ref)
