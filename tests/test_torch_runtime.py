"""PyTorch port, runtime: checkpoint/resume, the prefetchers, the profiler
trace, the NaN sanitizer and the precomputed-disparity mode, on the CPU,
against the JAX package's runtime on the same frames (the small 192x256
identity rig of the JAX runtime tests)."""

import dataclasses
import json
import os
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.config import BAConfig
from online_3d_reconstruction_tpu.io.dataset import SyntheticSequence
from online_3d_reconstruction_tpu.io.synthetic import (
    Plateau,
    SyntheticScene,
    make_survey_trajectory,
    nadir_pose,
)
from online_3d_reconstruction_tpu.runtime import pipeline as jpipe
from online_3d_reconstruction_tpu.utils.metrics import ate_rmse
from online_3d_reconstruction_tpu_torch.odometry import rigid
from online_3d_reconstruction_tpu_torch.runtime import checkpoint, pipeline, prefetch
from online_3d_reconstruction_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from tests.test_odometry import _test_config, vo_rig, vo_scene  # noqa: F401
from tests.test_torch_pipeline import _angle, _jax_samples
from tests.test_torch_shared import port

torch.set_num_threads(2)


def _runtime(cfg, **kw):
    return cfg.replace(runtime=dataclasses.replace(cfg.runtime, **kw))


def _variant_config(host_ba, **runtime):
    return _runtime(_test_config(), host_ba=host_ba, **runtime)


@pytest.fixture(scope="module")
def frames(vo_scene, vo_rig):
    poses = [nadir_pose(0.8 * i, 0.1 * i, 12.0) for i in range(6)]
    dataset = SyntheticSequence(scene=vo_scene, rig=vo_rig, poses=poses)
    return [dataset[i] for i in range(6)]


@pytest.fixture(scope="module")
def jax_runs(frames, vo_rig, tmp_path_factory):
    """The JAX package's uninterrupted runs, with its RANSAC draws, for the
    device window (snapshotting every 2nd keyframe) and the host table."""
    runs = {}
    for host_ba in (False, True):
        ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
        cfg = _variant_config(host_ba, checkpoint_every=0 if host_ba else 2,
                              checkpoint_dir=ckpt)
        engine = jpipe.OnlineReconstructor(cfg, vo_rig)
        for f in frames:
            engine.process(f)
        runs[host_ba] = (engine.finish(), ckpt)
    return runs


@pytest.mark.parametrize("host_ba", [False, True], ids=["device_window", "host_ba"])
def test_resume_matches_uninterrupted(frames, vo_rig, jax_runs, tmp_path, monkeypatch,
                                      host_ba):
    """Snapshot after frame 2, restore into a fresh engine, continue: the
    trajectory equals the uninterrupted port run's to f32 round-off of the
    snapshot (the reference test's 1e-5 m), with the same keyframes and map
    size; both are within the slice tolerances (1e-3 m, 1e-3 rad, map 0.5%)
    of the JAX package's uninterrupted run on the same RANSAC draws."""
    monkeypatch.setattr(rigid, "hypothesis_indices", _jax_samples)
    cfg = _variant_config(host_ba)
    eng_a = pipeline.OnlineReconstructor(port(cfg), port(vo_rig), device="cpu")
    for f in port(frames):
        eng_a.process(f)
    res_a = eng_a.finish()

    eng_b1 = pipeline.OnlineReconstructor(port(cfg), port(vo_rig), device="cpu")
    for f in port(frames[:3]):
        eng_b1.process(f)
    snap = str(tmp_path / "snap.npz")
    save_checkpoint(eng_b1, snap)
    eng_b2 = pipeline.OnlineReconstructor(port(cfg), port(vo_rig), device="cpu")
    load_checkpoint(eng_b2, snap)
    assert eng_b2.frame_idx == 3 and len(eng_b2.trajectory) == 3
    assert (eng_b2._ba is not None) == host_ba
    for f in port(frames[3:]):
        eng_b2.process(f)
    res_b = eng_b2.finish()

    np.testing.assert_allclose(res_b.trajectory, res_a.trajectory, rtol=1e-4, atol=1e-5)
    assert len(res_b.map_points) == len(res_a.map_points)
    np.testing.assert_array_equal(res_b.keyframe_indices, res_a.keyframe_indices)
    want = jax_runs[host_ba][0]
    np.testing.assert_array_equal(res_b.keyframe_indices, want.keyframe_indices)
    for res in (res_a, res_b):
        assert np.abs(res.trajectory[:, :3, 3] - want.trajectory[:, :3, 3]).max() < 1e-3
        assert _angle(res.trajectory, want.trajectory).max() < 1e-3
        assert abs(len(res.map_points) - len(want.map_points)) <= 0.005 * len(want.map_points)


def test_checkpoint_atomicity(frames, vo_rig, tmp_path, monkeypatch):
    """The snapshot is absent or complete (temp file + rename): it creates
    its directory, leaves no .tmp behind, and a failed write leaves the
    previous snapshot as it was."""
    eng = pipeline.OnlineReconstructor(port(_test_config()), port(vo_rig), device="cpu")
    eng.process(port(frames[0]))
    snap = tmp_path / "sub" / "snap.npz"
    save_checkpoint(eng, str(snap))
    assert snap.exists()
    assert not [f for f in os.listdir(tmp_path / "sub") if f.endswith(".tmp")]
    before = snap.read_bytes()

    def failing_write(f, **payload):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez_compressed", failing_write)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(eng, str(snap))
    assert snap.read_bytes() == before
    assert not [f for f in os.listdir(tmp_path / "sub") if f.endswith(".tmp")]


def test_checkpoint_every_writes_on_the_nth_keyframe(frames, vo_rig, jax_runs, tmp_path,
                                                     monkeypatch):
    """``checkpoint_every=2`` snapshots on every 2nd keyframe, as the
    reference does, and the last snapshot resumes at the frame after it.
    The reference's hook saves before its frame counter moves on, so its
    snapshot's frame index lags its trajectory by one (a resume from it
    would run that frame twice); the port's agree."""
    saved = []

    def spy(engine, path):
        saved.append((engine.frame_idx - 1, len(engine.keyframes)))
        save_checkpoint(engine, path)

    monkeypatch.setattr(pipeline, "save_checkpoint", spy)
    cfg = _variant_config(False, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    eng = pipeline.OnlineReconstructor(port(cfg), port(vo_rig), device="cpu")
    for f in port(frames):
        eng.process(f)
    kf = [k.index for k in eng.keyframes]
    assert len(kf) >= 4
    assert saved == [(kf[n - 1], n) for n in range(2, len(kf) + 1, 2)]
    with np.load(tmp_path / "snapshot.npz") as z:
        assert int(z["frame_idx"]) == saved[-1][0] + 1 == len(z["trajectory"])
        assert int(z["n_keyframes"]) == saved[-1][1]
        assert "bawin_count" in z and "rng_key" not in z
    with np.load(os.path.join(jax_runs[False][1], "snapshot.npz")) as z:
        assert int(z["frame_idx"]) == saved[-1][0] == len(z["trajectory"]) - 1
        assert int(z["n_keyframes"]) == saved[-1][1]


def _fake_engine(frame_idx=0):
    return SimpleNamespace(
        frame_idx=frame_idx, device=torch.device("cpu"),
        pack=lambda frame, frame_index: np.array([frame, frame_index], dtype=np.uint8))


def test_device_prefetch_order_and_frame_indices(frames, vo_rig):
    """Frames come out in order, each with its packed buffer as a CPU
    tensor, numbered from the engine's (restored) frame index; the real
    engine's buffer carries that index in its header."""
    out = list(prefetch.device_prefetch(range(7), _fake_engine(5), depth=2))
    assert [f for f, _ in out] == list(range(7))
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu" for _, p in out)
    assert [p.tolist() for _, p in out] == [[i, 5 + i] for i in range(7)]

    engine = pipeline.OnlineReconstructor(port(_test_config()), port(vo_rig), device="cpu")
    engine.frame_idx = 3   # as load_checkpoint leaves it
    tframes = port(frames)
    got = list(prefetch.device_prefetch(tframes[3:], engine, depth=1))
    for i, (frame, packed) in enumerate(got):
        assert frame is tframes[3 + i]
        np.testing.assert_array_equal(packed.numpy(), engine.pack(frame, frame_index=3 + i))
        assert packed[:80].view(torch.float32)[16].item() == 3 + i


def test_prefetch_worker_errors_reach_the_consumer():
    def source():
        yield 0
        yield 1
        raise OSError("frame 2 unreadable")

    for it in (prefetch.device_prefetch(source(), _fake_engine(), depth=3),
               prefetch.prefetch(source(), depth=3)):
        got = []
        with pytest.raises(OSError, match="frame 2 unreadable"):
            for item in it:
                got.append(item)
        assert len(got) == 2

    def bad_pack(frame, frame_index):
        raise ValueError("cannot pack")

    engine = SimpleNamespace(frame_idx=0, device=torch.device("cpu"), pack=bad_pack)
    with pytest.raises(ValueError, match="cannot pack"):
        list(prefetch.device_prefetch(range(3), engine, depth=2))


def test_prefetch_depth_zero_and_close():
    """``depth <= 0`` yields (frame, None) with no worker; ``prefetch``
    hands the source back; ``close`` stops a worker blocked on a full
    queue of an endless source."""
    assert list(prefetch.device_prefetch(range(3), _fake_engine(), depth=0)) == [
        (0, None), (1, None), (2, None)]
    src = [1, 2]
    assert prefetch.prefetch(src, depth=0) is src
    assert list(prefetch.prefetch(iter(src), depth=1)) == src

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = threading.active_count()
    it = prefetch.device_prefetch(endless(), _fake_engine(), depth=2)
    stream = iter(it)
    assert [next(stream)[0] for _ in range(3)] == [0, 1, 2]
    it.close()
    assert not it._worker._thread.is_alive()
    assert threading.active_count() <= before


def test_profile_flag_writes_trace(vo_scene, vo_rig, tmp_path):
    """``runtime.profile`` writes the program's own trace under
    ``<checkpoint_dir>/profile`` (the reference test's check, plus the trace
    being Chrome-trace JSON with each frame's ``process`` span and the
    stages' device stamps in it)."""
    cfg = _runtime(_test_config(), profile=True, checkpoint_dir=str(tmp_path))
    ds = SyntheticSequence(scene=vo_scene, rig=vo_rig,
                           poses=[nadir_pose(0.0, 0.0, 12.0), nadir_pose(0.5, 0.0, 12.0)])
    result = pipeline.reconstruct(port(ds), port(cfg), port(vo_rig), device="cpu")
    assert result.trajectory.shape == (2, 4, 4)
    found = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "profile") for f in fs]
    assert found == [str(tmp_path / "profile" / "trace.json")], found
    with open(found[0]) as fh:
        events = json.load(fh)["traceEvents"]
    process = [e for e in events if e.get("name") == "process" and e.get("ph") == "X"]
    assert sorted(e["args"]["frame"] for e in process) == [0, 1]
    stages = {e["name"] for e in events if e.get("cat") == "stage"}
    assert {"rectify", "disparity", "features", "cloud", "insert"} <= stages
    assert "tracking" in stages   # the steady frame's stage


def _nan_prior_frames(frames, at):
    prior = frames[at].prior_pose.copy()
    prior[0, 3] = np.nan
    return frames[:at] + [frames[at]._replace(prior_pose=prior)]


def test_debug_nans_names_the_stage(frames, vo_rig):
    """A NaN flight-log prior on frame 2: the port raises FloatingPointError
    naming the first stage whose output holds it (the unpacked prior) and
    the frame, where the JAX engine with ``debug_nans`` raises
    FloatingPointError too; a clean run with the check on gives the
    trajectory of a run without it, bit for bit."""
    cfg = _runtime(_test_config(), debug_nans=True)
    bad = _nan_prior_frames(frames, 2)
    engine = pipeline.OnlineReconstructor(port(cfg), port(vo_rig), device="cpu")
    with pytest.raises(FloatingPointError, match="unpack stage at frame 2"):
        for f in port(bad):
            engine.process(f)
    try:
        # the reference's jit cache holds this module's earlier compiles,
        # whose fast dispatch path skips the NaN check
        jax.clear_caches()
        jengine = jpipe.OnlineReconstructor(cfg, vo_rig)
        with pytest.raises(FloatingPointError):
            for f in bad:
                jengine.process(f)
    finally:
        jax.config.update("jax_debug_nans", False)

    clean = [pipeline.reconstruct(port(frames[:3]), port(c), port(vo_rig),
                                  device="cpu").trajectory
             for c in (cfg, _test_config())]
    np.testing.assert_array_equal(clean[0], clean[1])


def test_debug_nans_checks_the_first_frame(frames, vo_rig):
    """The first frame has no unpack stage: a NaN prior reaches the map
    insert, which names it."""
    cfg = _runtime(_test_config(), debug_nans=True)
    engine = pipeline.OnlineReconstructor(port(cfg), port(vo_rig), device="cpu")
    with pytest.raises(FloatingPointError, match="insert stage at frame 0"):
        engine.process(port(_nan_prior_frames(frames, 0)[0]))


def test_precomputed_disparity_bypasses_sgm(vo_scene, vo_rig, monkeypatch):
    """Port mirror of the reference's offline-mode test: with
    ``runtime.use_precomputed_disparity`` the SGM stage never runs, and the
    ground-truth maps give a trajectory that beats the noisy priors (the
    reference test's bounds: ATE < 0.35 m, > 400 map points)."""
    def _boom(*a, **k):
        raise AssertionError("sgm_disparity ran in precomputed mode")

    monkeypatch.setattr(pipeline, "sgm_disparity", _boom)
    cfg = _runtime(_test_config(), use_precomputed_disparity=True)
    poses = make_survey_trajectory(8, altitude=12.0, speed=0.7, row_length=7.0, seed=3)
    dataset = SyntheticSequence(scene=vo_scene, rig=vo_rig, poses=poses,
                                prior_translation_sigma=0.15)
    assert dataset[0].disparity is not None
    result = pipeline.reconstruct(port(dataset), port(cfg), port(vo_rig), device="cpu")
    ate = ate_rmse(result.trajectory, np.stack(poses))
    assert ate < 0.35, f"ATE {ate:.3f} m with GT disparity"
    assert len(result.map_points) > 400


def test_full_stack_beats_prior_dead_reckoning(vo_rig):
    """Port mirror of the reference's estimator-quality test: the product
    estimator (whitened 3x3 stereo information, huber 3 sigma, priors at
    their 1/sigma^2) on a 12-frame anti-aliased survey with the exact
    disparity, the port's own RANSAC draw: full-stack ATE <= 0.8x the
    prior-only ATE (the reference's bound)."""
    cfg = _test_config()
    cfg = dataclasses.replace(
        cfg,
        ba=BAConfig(obs_weighting=True, sigma_pixel=0.5, sigma_disparity=1.0,
                    huber_delta=3.0, prior_position_weight=1.0 / 0.2**2,
                    prior_rotation_weight=1.0 / 0.01**2),
        runtime=dataclasses.replace(cfg.runtime, use_precomputed_disparity=True),
    )
    scene = SyntheticScene(seed=11, plateaus=[Plateau(x_min=-3.0, x_max=3.0, y_min=-2.0,
                                                      y_max=4.0, height=4.0)],
                           supersample=2)
    poses = make_survey_trajectory(12, altitude=12.0, speed=0.7, row_length=7.0, seed=5)
    dataset = SyntheticSequence(scene=scene, rig=vo_rig, poses=poses,
                                prior_translation_sigma=0.2, prior_rotation_sigma=0.01)
    frames = [dataset[i] for i in range(len(dataset))]
    gt = np.stack(poses)
    ate_prior = ate_rmse(np.stack([f.prior_pose for f in frames]), gt)
    result = pipeline.reconstruct(port(frames), port(cfg), port(vo_rig), device="cpu")
    ate_full = ate_rmse(result.trajectory, gt)
    assert ate_full <= 0.8 * ate_prior, (ate_full, ate_prior)


def test_offline_map_is_the_scene_surfaces_in_both_packages(frames, vo_rig, jax_runs,
                                                            monkeypatch):
    """Offline mode (the exact disparity) gives a much smaller map than the
    online run on SGM's disparity, in the reference exactly as in the port:
    exact depth puts every point on the ground plane or the plateau top (4 m
    here), one layer of 0.5 m voxels, where SGM's depth noise spreads a
    surface over several layers. Map sizes of the two packages within 0.5%
    in both modes (the slice tolerance); the offline map under 0.6x of the
    online one; every offline point within one voxel of a surface."""
    monkeypatch.setattr(rigid, "hypothesis_indices", _jax_samples)
    sizes = {}
    for offline in (False, True):
        cfg = _variant_config(False, use_precomputed_disparity=offline)
        want = (jpipe.reconstruct(frames, cfg, vo_rig) if offline else jax_runs[False][0])
        got = pipeline.reconstruct(port(frames), port(cfg), port(vo_rig), device="cpu")
        sizes[offline] = (len(want.map_points), len(got.map_points))
        assert abs(sizes[offline][1] - sizes[offline][0]) <= 0.005 * sizes[offline][0]
        for result in (want, got):
            z = result.map_points[:, 2]
            on_surface = float(((np.abs(z) < 0.5) | (np.abs(z - 4.0) < 0.5)).mean())
            assert on_surface == 1.0 if offline else on_surface < 0.8, (offline, on_surface)
    for package in (0, 1):
        assert sizes[True][package] < 0.6 * sizes[False][package], sizes


def test_snapshot_bytes_key_by_key_against_jax(frames, vo_rig, jax_runs, tmp_path,
                                               monkeypatch):
    """The port's snapshot of the same run against the reference's
    ``save_checkpoint``: the same keys but the reference's ``rng_key`` and the
    port's ``frames_since_fuse``, every array at the reference's shape and
    dtype (no key stored wider; the 0-dim counters apart), and the stored
    (deflated) bytes within 1% in total, the two map pools' points and colors
    making up over 0.8 of them."""
    import zipfile

    monkeypatch.setattr(rigid, "hypothesis_indices", _jax_samples)
    cfg = _variant_config(False, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    pipeline.reconstruct(port(frames), port(cfg), port(vo_rig), device="cpu")
    paths = (os.path.join(jax_runs[False][1], "snapshot.npz"), tmp_path / "snapshot.npz")
    stored = [{i.filename[:-4]: i.compress_size for i in zipfile.ZipFile(p).infolist()}
              for p in paths]
    with np.load(paths[0]) as want, np.load(paths[1]) as got:
        assert set(got.files) - set(want.files) == {"frames_since_fuse"}
        assert set(want.files) - set(got.files) == {"rng_key"}
        for key in set(want.files) & set(got.files):
            assert got[key].shape == want[key].shape, key
            if want[key].ndim:
                assert got[key].dtype == want[key].dtype, (key, got[key].dtype)
    total = [sum(s.values()) for s in stored]
    assert abs(total[1] - total[0]) <= 0.01 * total[0], total
    pools = sum(stored[1][f"{pool}_{part}"] for pool in ("map", "stg")
                for part in ("points", "colors"))
    assert pools > 0.8 * total[1], (pools, total)
    # the narrow dtypes widen again on load
    engine = pipeline.OnlineReconstructor(port(cfg), port(vo_rig), device="cpu")
    load_checkpoint(engine, str(paths[1]))
    assert engine.keyframes[-1].features.keypoints.descriptors.dtype == torch.int64
    assert engine.keyframes[-1].features.keypoints.octave.dtype == torch.int64
    assert engine._ba_state.match_idx.dtype == torch.int64
