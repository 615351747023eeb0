"""PyTorch port, its own copies of the shared host-side modules (config,
io.calibration, io.synthetic, io.dataset's frame sources and flight-log
parsers, io.export's writers, io.viewer, io.native_loader, utils.metrics,
utils.imaging)
against the JAX package's on the same seeded numpy inputs. These are numpy
copies, so every comparison is exact (no tolerance).

``port`` carries a reference configuration, rig, frame or sequence of
frames across as plain data; the other test files of the port use it to
hand each package objects of its own classes.
"""

import dataclasses
import json

import numpy as np
import pytest

from online_3d_reconstruction_tpu import config as jconfig
from online_3d_reconstruction_tpu.io import calibration as jcal
from online_3d_reconstruction_tpu.io import dataset as jdataset
from online_3d_reconstruction_tpu.io import export as jexport
from online_3d_reconstruction_tpu.io import native_loader as jnative
from online_3d_reconstruction_tpu.io import synthetic as jsyn
from online_3d_reconstruction_tpu.io import viewer as jviewer
from online_3d_reconstruction_tpu.utils import imaging as jimaging
from online_3d_reconstruction_tpu.utils import metrics as jmetrics
from online_3d_reconstruction_tpu_torch import config as tconfig
from online_3d_reconstruction_tpu_torch.io import calibration as tcal
from online_3d_reconstruction_tpu_torch.io import dataset as tdataset
from online_3d_reconstruction_tpu_torch.io import export as texport
from online_3d_reconstruction_tpu_torch.io import native_loader as tnative
from online_3d_reconstruction_tpu_torch.io import synthetic as tsyn
from online_3d_reconstruction_tpu_torch.io import viewer as tviewer
from online_3d_reconstruction_tpu_torch.utils import imaging as timaging
from online_3d_reconstruction_tpu_torch.utils import metrics as tmetrics

_SECTION_OF = {cls.__name__: name for name, cls in jconfig._SECTIONS.items()}


def port(obj):
    """The port's own object for a reference configuration (whole or one
    section), rectified rig, calibration, frame, or iterable of frames,
    carried across as plain data (dicts, numpy arrays, numbers)."""
    if isinstance(obj, jconfig.PipelineConfig):
        return tconfig.config_from_dict(jconfig.config_to_dict(obj))
    if type(obj).__name__ in _SECTION_OF and dataclasses.is_dataclass(obj):
        return tconfig.section_from_dict(_SECTION_OF[type(obj).__name__],
                                         dataclasses.asdict(obj))
    if isinstance(obj, jcal.RectifiedRig):
        return tcal.rig_from_numpy(vars(obj))
    if isinstance(obj, jcal.CameraIntrinsics):
        return tcal.CameraIntrinsics(**dataclasses.asdict(obj))
    if isinstance(obj, jcal.StereoCalibration):
        return tcal.StereoCalibration(left=port(obj.left), right=port(obj.right),
                                      rotation=np.array(obj.rotation),
                                      translation=np.array(obj.translation))
    if isinstance(obj, jdataset.FrameData):
        return tdataset.frame_from_numpy(obj._asdict())
    if isinstance(obj, (list, tuple, jdataset.SyntheticSequence)):
        return [port(item) for item in obj]
    raise TypeError(f"nothing to carry across for {type(obj).__name__}")


def _assert_same(a, b, path="value"):
    """Exact equality of nested plain data, dtypes of arrays included."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("section", sorted(jconfig._SECTIONS))
def test_config_section_fields_and_defaults_equal(section):
    jcls, tcls = jconfig._SECTIONS[section], tconfig._SECTIONS[section]
    assert jcls is not tcls and jcls.__name__ == tcls.__name__
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in jf] == [f.name for f in tf]
    assert [f.type for f in jf] == [f.type for f in tf]
    _assert_same(dataclasses.asdict(jcls()), dataclasses.asdict(tcls()), section)


def test_config_round_trip_through_plain_data():
    """A non-default reference configuration -> dict -> the port's -> dict,
    also through JSON (lists for tuples), and ``port`` on one section."""
    jcfg = jconfig.PipelineConfig(
        stereo=jconfig.StereoConfig(height=96, width=128, max_disparity=16, num_paths=8,
                                    census_window=(7, 5), p1=7.5),
        ba=jconfig.BAConfig(window=24, max_landmarks=2048, obs_weighting=True),
        runtime=jconfig.RuntimeConfig(checkpoint_dir="snap", host_ba=True))
    plain = jconfig.config_to_dict(jcfg)
    tcfg = tconfig.config_from_dict(plain)
    assert isinstance(tcfg, tconfig.PipelineConfig)
    assert isinstance(tcfg.stereo, tconfig.StereoConfig)
    _assert_same(tconfig.config_to_dict(tcfg), plain, "config")
    assert tconfig.config_from_dict(json.loads(json.dumps(plain))) == tcfg
    assert port(jcfg) == tcfg and port(jcfg.ba) == tcfg.ba
    assert tconfig.config_to_dict(tconfig.PipelineConfig()) == \
        jconfig.config_to_dict(jconfig.PipelineConfig())
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.section_from_dict("stereo", {"no_such_field": 1})
    with pytest.raises(KeyError, match="unknown config section"):
        tconfig.section_from_dict("nothing", {})


def test_load_config_file_and_overrides_equal(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"stereo": {"max_disparity": 32, "census_window": [7, 7]},
                                "mapping": {"voxel_size": 0.5}}))
    overrides = {"features.max_keypoints": 128, "runtime.prefetch_depth": 0}
    assert tconfig.config_to_dict(tconfig.load_config(str(path), overrides)) == \
        jconfig.config_to_dict(jconfig.load_config(str(path), overrides))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _calib(mod, h=48, w=64):
    cam = mod.CameraIntrinsics(fx=60.0, fy=61.0, cx=w / 2 + 0.5, cy=h / 2 - 0.25, width=w,
                               height=h, dist=(-0.08, 0.01, 3e-4, -3e-4, 1e-3))
    rot = jcal._rodrigues_exp(np.array([0.01, -0.02, 0.005]))
    return mod.StereoCalibration(left=cam, right=cam, rotation=rot,
                                 translation=np.array([-0.5, 0.01, -0.02]))


def test_stereo_rectify_maps_and_q_equal():
    jrig, trig = jcal.stereo_rectify(_calib(jcal)), tcal.stereo_rectify(_calib(tcal))
    assert isinstance(trig, tcal.RectifiedRig)
    _assert_same(vars(trig), vars(jrig), "rig")
    carried = port(jrig)
    assert isinstance(carried, tcal.RectifiedRig)
    _assert_same(vars(carried), vars(jrig), "carried rig")
    assert carried.map_left is not jrig.map_left
    assert port(_calib(jcal)).left == _calib(tcal).left


def test_identity_rig_and_calibration_json_equal(tmp_path):
    args = (200.0, 201.0, 64.0, 48.0, 0.5, 128, 96)
    _assert_same(vars(tcal.identity_rig(*args)), vars(jcal.identity_rig(*args)), "rig")
    path = tmp_path / "calib.json"
    cam = dict(fx=60.0, fy=61.0, cx=32.0, cy=24.0, width=64, height=48,
               dist=[-0.08, 0.01, 3e-4, -3e-4, 0.0])
    path.write_text(json.dumps({"left": cam, "right": cam,
                                "translation": [-0.4, 0.0, 0.0]}))
    jc, tc = jcal.load_calibration_json(str(path)), tcal.load_calibration_json(str(path))
    assert dataclasses.asdict(tc.left) == dataclasses.asdict(jc.left)
    _assert_same(tc.rotation, jc.rotation)
    _assert_same(tc.translation, jc.translation)
    assert tc.baseline == jc.baseline


# ---------------------------------------------------------------------------
# synthetic scene and sequences
# ---------------------------------------------------------------------------

def _sequence(syn, dataset, cal, distorted):
    h, w = 48, 64
    scene = syn.SyntheticScene(seed=5, plateaus=[syn.Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                               supersample=2)
    poses = syn.make_survey_trajectory(3, altitude=15.0, speed=0.6)
    if distorted:
        calib = _calib(cal, h, w)
        rig = cal.stereo_rectify(calib)
    else:
        calib, rig = None, cal.identity_rig(60.0, 60.0, w / 2, h / 2, 0.5, w, h)
    return dataset.SyntheticSequence(scene=scene, rig=rig, poses=poses, calib=calib,
                                     prior_seed=3)


@pytest.mark.parametrize("distorted", [False, True])
def test_synthetic_sequence_frames_and_priors_byte_equal(distorted):
    jseq = _sequence(jsyn, jdataset, jcal, distorted)
    tseq = _sequence(tsyn, tdataset, tcal, distorted)
    assert len(tseq) == len(jseq) == 3
    for i, (tf, jf) in enumerate(zip(tseq, jseq)):
        assert isinstance(tf, tdataset.FrameData) and not isinstance(tf, jdataset.FrameData)
        _assert_same(tf._asdict(), jf._asdict(), f"frame {i}")
        carried = port(jf)
        assert isinstance(carried, tdataset.FrameData)
        _assert_same(carried._asdict(), jf._asdict(), f"carried frame {i}")
    assert [type(f) for f in port(jseq)] == [tdataset.FrameData] * 3


def test_trajectories_and_prior_noise_equal():
    _assert_same(tsyn.make_survey_trajectory(7, altitude=30.0, speed=1.2),
                 jsyn.make_survey_trajectory(7, altitude=30.0, speed=1.2))
    _assert_same(tsyn.make_orbit_trajectory(5), jsyn.make_orbit_trajectory(5))
    _assert_same(tsyn.nadir_pose(1.0, -2.0, 20.0, 0.3), jsyn.nadir_pose(1.0, -2.0, 20.0, 0.3))
    poses = jsyn.make_survey_trajectory(5, altitude=30.0, speed=1.2)
    _assert_same(tsyn.perturb_poses(poses, 0.15, 0.01, seed=4),
                 jsyn.perturb_poses(poses, 0.15, 0.01, seed=4))


def test_frame_from_numpy_keeps_unknown_fields_none():
    frame = tdataset.frame_from_numpy(dict(
        left=np.zeros((2, 3), np.float32), right=np.ones((2, 3), np.float32),
        color=np.zeros((2, 3, 3), np.float32), prior_pose=np.eye(4, dtype=np.float32),
        timestamp=np.float64(0.5)))
    assert frame.gt_pose is None and frame.disparity is None
    assert type(frame.timestamp) is float and frame.right.dtype == np.float32


# ---------------------------------------------------------------------------
# flight logs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["xyz_quaternion", "gps_euler"])
def test_flight_log_parsers_equal(tmp_path, kind):
    rng = np.random.default_rng(11)
    n = 9
    t = np.arange(n) * 0.1
    if kind == "xyz_quaternion":
        header = "timestamp,x,y,z,qw,qx,qy,qz"
        rows = np.column_stack([t, rng.normal(0, 20, (n, 3)), rng.normal(size=(n, 4))])
    else:
        header = "Timestamp, Lat ,lon,alt,roll,pitch,yaw"
        rows = np.column_stack([t, 47.0 + rng.normal(0, 1e-3, n), 8.0 + rng.normal(0, 1e-3, n),
                                400.0 + rng.normal(0, 5.0, n),
                                rng.uniform(-np.pi, np.pi, (n, 3))])
    path = tmp_path / "log.csv"
    with open(path, "w") as f:
        f.write(header + "\n# a comment\n\n")
        for row in rows:
            f.write(",".join(repr(float(v)) for v in row) + "\n")
    tlog, jlog = tdataset.load_flight_log(str(path)), jdataset.load_flight_log(str(path))
    _assert_same(tlog, jlog, "log")
    image_times = np.array([-1.0, 0.04, 0.05, 0.26, 0.8, 0.95, 3.0])
    for max_dt in (0.1, 0.02):
        _assert_same(tdataset.match_poses_to_timestamps(tlog["timestamp"], image_times, max_dt),
                     jdataset.match_poses_to_timestamps(jlog["timestamp"], image_times, max_dt))
    if kind == "gps_euler":
        origin = np.array([0.82, 0.14, 390.0])
        for org in (None, origin):
            _assert_same(tdataset.gps_to_local(rows[:, 1], rows[:, 2], rows[:, 3], org),
                         jdataset.gps_to_local(rows[:, 1], rows[:, 2], rows[:, 3], org))
    bad = tmp_path / "bad.csv"
    bad.write_text("timestamp,a,b\n0.0,1.0,2.0\n")
    with pytest.raises(ValueError, match="neither lat/lon/alt nor x/y/z"):
        tdataset.load_flight_log(str(bad))


# ---------------------------------------------------------------------------
# writers, viewer, native loader
# ---------------------------------------------------------------------------

def _cloud(n=257):
    rng = np.random.default_rng(2)
    return rng.normal(0, 10, (n, 3)).astype(np.float32), rng.uniform(0, 1, (n, 3))


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("fmt", ["ply", "pcd"])
def test_cloud_writers_byte_equal(tmp_path, fmt, binary):
    pts, cols = _cloud()
    for colors in (cols, None, (cols * 255).astype(np.uint8)):
        for mod, name in ((texport, "t"), (jexport, "j")):
            getattr(mod, "save_" + fmt)(str(tmp_path / f"{name}.{fmt}"), pts, colors,
                                        binary=binary)
        assert (tmp_path / f"t.{fmt}").read_bytes() == (tmp_path / f"j.{fmt}").read_bytes()
    if fmt == "ply":
        _assert_same(texport.load_ply(str(tmp_path / "j.ply")),
                     jexport.load_ply(str(tmp_path / "t.ply")))
    texport.save_pcd(str(tmp_path / "empty.pcd"), np.zeros((0, 3), np.float32))
    assert b"POINTS 0" in (tmp_path / "empty.pcd").read_bytes()


def test_tum_writer_byte_equal(tmp_path):
    """Both quaternion branches of the writer: trace > 0 and each of the
    three largest-diagonal cases."""
    rng = np.random.default_rng(8)
    poses = np.tile(np.eye(4), (8, 1, 1))
    for i, phi in enumerate([(0.1, 0.2, -0.1), (3.0, 0.1, 0.0), (0.1, 3.0, 0.0),
                             (0.0, 0.1, 3.0), (2.0, 2.0, 0.5), (0.0, 0.0, 0.0),
                             (-1.5, 0.4, 2.2), (3.1, -0.2, 0.1)]):
        poses[i, :3, :3] = jcal._rodrigues_exp(np.array(phi))
        poses[i, :3, 3] = rng.normal(0, 30, 3)
    stamps = 100.0 + np.arange(8) * 0.1
    for ts, tag in ((stamps, "s"), (None, "n")):
        texport.save_trajectory_tum(str(tmp_path / f"t{tag}.tum"), poses, ts)
        jexport.save_trajectory_tum(str(tmp_path / f"j{tag}.tum"), poses, ts)
        assert (tmp_path / f"t{tag}.tum").read_bytes() == (tmp_path / f"j{tag}.tum").read_bytes()


def test_viewer_html_byte_equal(tmp_path):
    pts, cols = _cloud(300)
    traj = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    traj[:, :3, 3] = np.arange(12, dtype=np.float32).reshape(4, 3)
    tviewer.export_html(str(tmp_path / "t.html"), pts, cols, traj)
    jviewer.export_html(str(tmp_path / "j.html"), pts, cols, traj)
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    assert (tmp_path / "t.html").stat().st_size > 1000


def test_native_loader_finds_the_same_library(tmp_path):
    """The copy sits at the reference's depth, so it resolves the same
    native/ directory; where the library loads, both decode the same bytes."""
    assert tnative._NATIVE_DIR == jnative._NATIVE_DIR
    assert tnative._LIB_PATH == jnative._LIB_PATH
    assert tnative.available() == jnative.available()
    if not tnative.available():
        pytest.skip("native/libo3r_io.so neither loads nor builds here")
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    with open(tmp_path / "g.pgm", "wb") as f:
        f.write(b"P5\n9 7\n255\n" + gray.tobytes())
    np.save(tmp_path / "f.npy", rng.normal(size=(5, 6, 3)).astype(np.float32))
    for name in ("g.pgm", "f.npy"):
        _assert_same(tnative.read_image(str(tmp_path / name)),
                     jnative.read_image(str(tmp_path / name)))
    np.testing.assert_array_equal(tnative.read_image(str(tmp_path / "g.pgm")), gray)
    paths = [str(tmp_path / "g.pgm")] * 3
    got = list(tnative.NativePrefetcher(paths, depth=2, threads=2))
    assert len(got) == 3 and all(np.array_equal(g, gray) for g in got)
    with pytest.raises(IOError):
        tnative.read_image(str(tmp_path / "missing.pgm"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("align", [False, True])
def test_ate_and_rpe_equal(align):
    rng = np.random.default_rng(6)
    gt = jsyn.make_survey_trajectory(12, altitude=30.0, speed=1.2)
    est = jsyn.perturb_poses(gt, 0.15, 0.01, seed=2)
    est = np.asarray(est, dtype=np.float32)
    gt = np.asarray(gt, dtype=np.float32) + rng.normal(0, 1e-3, (12, 4, 4)).astype(np.float32)
    a, b = tmetrics.ate_rmse(est, gt, align=align), jmetrics.ate_rmse(est, gt, align=align)
    assert type(a) is type(b) and a == b and 0.0 < a < 1.0
    _assert_same(tmetrics.rpe_stats(est, gt, delta=2), jmetrics.rpe_stats(est, gt, delta=2))


def test_metrics_logger_and_timer_equal(tmp_path):
    records = [{"frame": i, "t_stereo": 0.01 * (1 + (i == 0) * 50), "t_vo": 0.02,
                "keyframe": i % 2 == 0, "inliers": 40 + i} for i in range(10)]
    out = []
    for mod, name in ((tmetrics, "t"), (jmetrics, "j")):
        logger = mod.MetricsLogger(str(tmp_path / f"{name}.jsonl"))
        for r in records:
            logger.log(dict(r))
        logger.close()
        out.append((logger.auto_warmup(), logger.summary(skip_first=1)))
    assert out[0] == out[1] and out[0][0] >= 1
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    # the port times its stages with the engine's tracer (runtime/trace.py)
    assert not hasattr(tmetrics, "StageTimer")


# ---------------------------------------------------------------------------
# imaging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [0, 3])
def test_bilinear_sample_and_to_uint8_equal(channels):
    """The numpy oracle of the remap gather: gray and colour, samples inside,
    on the border and outside the image, a non-zero fill."""
    import online_3d_reconstruction_tpu_torch.utils as tutils

    assert tutils.bilinear_sample_np is timaging.bilinear_sample_np
    rng = np.random.default_rng(9)
    image = rng.random((12, 17, channels) if channels else (12, 17)).astype(np.float32)
    x = rng.uniform(-2.0, 18.0, (20, 25))
    y = rng.uniform(-2.0, 13.0, (20, 25))
    x[0, :3], y[0, :3] = [0.0, 16.0, 15.5], [0.0, 11.0, 10.0]
    for fill in (0.0, -1.0):
        _assert_same(timaging.bilinear_sample_np(image, x, y, fill),
                     jimaging.bilinear_sample_np(image, x, y, fill))
    inside = timaging.bilinear_sample_np(image, x, y, -1.0) != -1.0
    assert 0 < inside.sum() < inside.size
    _assert_same(timaging.to_uint8(image * 1.2 - 0.1), jimaging.to_uint8(image * 1.2 - 0.1))
