"""PyTorch port, the multi-rank paths of ``parallel/``: each mirrored test
of tests/test_parallel.py with the port on FOUR CPU ranks (fresh processes
over gloo, ``parallel.launch.run_ranks``) against the JAX single-device
result computed here, at the reference tests' tolerances, every rank's
result compared; then the size-1 forms in process (no process group)
against the port's single-device forms and against the JAX functions on a
mesh of one device. JAX ``shard_map`` programs on many virtual devices are
never run here (the XLA:CPU rendezvous deadlock of tests/test_multidevice.py).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.ba import device_tracks as jdt
from online_3d_reconstruction_tpu.ba.schur import solve_ba as jsolve_ba
from online_3d_reconstruction_tpu.ba.testing import make_synthetic_bundle as jbundle
from online_3d_reconstruction_tpu.config import BAConfig, StereoConfig
from online_3d_reconstruction_tpu.geometry.backproject import PointCloud as JPointCloud
from online_3d_reconstruction_tpu.io.synthetic import nadir_pose
from online_3d_reconstruction_tpu.mapping.voxel import voxel_downsample as jvoxel_downsample
from online_3d_reconstruction_tpu.parallel import ba_sharded as jba_sharded
from online_3d_reconstruction_tpu.parallel import frames as jframes
from online_3d_reconstruction_tpu.parallel import mesh as jmesh
from online_3d_reconstruction_tpu.parallel import sgm_sharded as jsgm_sharded
from online_3d_reconstruction_tpu.parallel import voxel_sharded as jvoxel_sharded
from online_3d_reconstruction_tpu.stereo.sgm import sgm_disparity as jsgm_disparity
from online_3d_reconstruction_tpu_torch.ba.problem import problem_from_numpy
from online_3d_reconstruction_tpu_torch.ba.schur import solve_ba
from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
from online_3d_reconstruction_tpu_torch.mapping.voxel import voxel_downsample
from online_3d_reconstruction_tpu_torch.parallel import (
    ba_sharded,
    frames,
    mesh as tmesh,
    sgm_sharded,
    voxel_sharded,
)
from online_3d_reconstruction_tpu_torch.parallel.launch import run_ranks
from online_3d_reconstruction_tpu_torch.stereo.sgm import sgm_disparity
from tests import test_torch_rank_jobs as jobs
from tests.test_torch_shared import port

torch.set_num_threads(2)
WORLD = 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud_arrays(seed, scale=4.0, n=1024):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (n, 3)).astype(np.float32),
            rng.random((n, 3)).astype(np.float32), rng.random(n) < 0.9)


def _valid_points(cloud):
    """(points, colors) of a cloud's valid slots, in lexicographic order."""
    valid = np.asarray(cloud["valid"] if isinstance(cloud, dict) else cloud.valid)
    get = (lambda k: cloud[k]) if isinstance(cloud, dict) else (lambda k: getattr(cloud, k))
    pts, cols = np.asarray(get("points"))[valid], np.asarray(get("colors"))[valid]
    order = np.lexsort(pts.T)
    return pts[order], cols[order]


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds) and the JAX single-device results
# ---------------------------------------------------------------------------

_BA_KW = dict(iters=4, damping=1e-4, huber_delta=0.5)
_UNEVEN_KW = dict(iters=3, damping=1e-4, huber_delta=0.0)
_WINDOW_CFG = BAConfig(window=4, max_landmarks=64, max_obs=512)
_BATCH_CFG = StereoConfig(height=192, width=256, max_disparity=16, num_paths=2,
                          use_pallas=False, speckle_window=0)
_SGM_CFG = StereoConfig(height=192, width=256, max_disparity=32, num_paths=8,
                        use_pallas=False)


@pytest.fixture(scope="module")
def problems():
    """The reference tests' bundles: (4 kf x 24 lm), (3 x 11 = 33
    observations, which pad at 4 ranks too), the slot-major (16 x 128, 32 a
    slot) and one whose 6 slots do not divide by 4."""
    return dict(
        ba=jbundle(np.random.default_rng(0), w=4, l=24, obs_noise=0.01)[0],
        ba_uneven=jbundle(np.random.default_rng(1), w=3, l=11)[0],
        slot=jbundle(np.random.default_rng(7), w=16, l=128, obs_noise=0.02,
                     n_cap=16 * 32, obs_per_kf=32)[0],
        slot_bad=jbundle(np.random.default_rng(8), w=6, l=16, n_cap=6 * 16)[0])


@pytest.fixture(scope="module")
def stereo_batch(scene, small_rig):
    frames_ = [scene.render_stereo(nadir_pose(2.0 * i, 0.0, 24.0), small_rig)
               for i in range(8)]
    return (np.stack([f.left for f in frames_]).astype(np.float32),
            np.stack([f.right for f in frames_]).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(problems, stereo_batch, stereo_frame, tmp_path_factory):
    """Every job of tests/test_torch_rank_jobs.py on four ranks, one launch:
    a list of the ranks' results."""
    workdir = tmp_path_factory.mktemp("ranks")
    inputs = {}
    for name, problem in problems.items():
        inputs.update(jobs.pack(name, problem))
    inputs["ba.kw"] = json.dumps(_BA_KW)
    inputs["ba_uneven.kw"] = json.dumps(_UNEVEN_KW)
    inputs["slot.kw"] = json.dumps(dict(_BA_KW, slot_major=32))
    inputs["window.cfg"] = json.dumps(dataclasses.asdict(_WINDOW_CFG))
    inputs["batch.cfg"] = json.dumps(dataclasses.asdict(_BATCH_CFG))
    inputs["batch.lefts"], inputs["batch.rights"] = stereo_batch
    for name, seed in (("voxel", 2), ("route", 5)):
        pts, cols, val = _cloud_arrays(seed)
        inputs.update(jobs.pack(name, dict(points=pts, colors=cols, valid=val)))
    inputs["overflow.points"] = _cloud_arrays(6, scale=30.0)[0]
    inputs["sgm.cfg"] = json.dumps(dataclasses.asdict(_SGM_CFG))
    inputs["sgm.left"] = np.asarray(stereo_frame.left, np.float32)
    inputs["sgm.right"] = np.asarray(stereo_frame.right, np.float32)
    np.savez(workdir / "inputs.npz", **inputs)
    return run_ranks("tests.test_torch_rank_jobs:parallel_jobs", WORLD, workdir,
                     timeout=240.0)


def _job(ranks, name):
    """The ranks' results of one job, each as a dict; fails on a job's error."""
    out = []
    for rank, result in enumerate(ranks):
        assert f"{name}/error" not in result, f"rank {rank}:\n{result[f'{name}/error']}"
        out.append({k.split("/", 1)[1]: v for k, v in result.items()
                    if k.startswith(name + "/")})
        assert out[-1], (name, rank)
    assert len(out) == WORLD
    return out


# ---------------------------------------------------------------------------
# four ranks against JAX on one device
# ---------------------------------------------------------------------------

class TestShardedBA:
    def test_matches_single_device(self, ranks, problems):
        p1, _, t1 = jsolve_ba(problems["ba"], **_BA_KW)
        got = _job(ranks, "ba")
        for r in got:
            np.testing.assert_allclose(r["poses"], np.asarray(p1), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(r["trace"], np.asarray(t1), rtol=1e-4)
            # replicated cost -> the same accept decisions -> equal bits
            np.testing.assert_array_equal(r["poses"], got[0]["poses"])
            np.testing.assert_array_equal(r["landmarks"], got[0]["landmarks"])

    def test_uneven_observation_count_padded(self, ranks, problems):
        assert problems["ba_uneven"].obs_kf.shape[0] % WORLD
        p1, _, _ = jsolve_ba(problems["ba_uneven"], **_UNEVEN_KW)
        for r in _job(ranks, "ba_uneven"):
            np.testing.assert_allclose(r["poses"], np.asarray(p1), rtol=1e-4, atol=1e-5)


class TestShardedWindowBA:
    def test_keyframe_core_matches_single_device(self, ranks):
        """The device-window keyframe event with the sharded solve on four
        ranks against the reference's single-device event."""
        state = jdt.create_window(_WINDOW_CFG.window, 64)
        for args in jobs.window_events():
            *head, pose = map(jnp.asarray, args)
            state, refined, _ = jdt.keyframe_core(state, *head, pose, pose, _WINDOW_CFG,
                                                  None)
        for r in _job(ranks, "window"):
            np.testing.assert_allclose(r["refined"], np.asarray(refined), rtol=1e-4,
                                       atol=1e-5)


class TestSlotShardedBA:
    def test_matches_single_device(self, ranks, problems):
        p1, l1, t1 = jsolve_ba(problems["slot"], slot_major=32, **_BA_KW)
        got = _job(ranks, "slot")
        for r in got:
            np.testing.assert_allclose(r["poses"], np.asarray(p1), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(r["landmarks"], np.asarray(l1), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(r["trace"], np.asarray(t1), rtol=1e-4)
            np.testing.assert_array_equal(r["poses"], got[0]["poses"])

    def test_rejects_bad_layout(self, ranks):
        for r in _job(ranks, "slot_bad"):
            assert "slot-sharded" in str(r["message"])


class TestBatchDisparity:
    def test_sharded_matches_unsharded(self, ranks, stereo_batch):
        lefts, rights = map(jnp.asarray, stereo_batch)
        d_ref, v_ref = jframes.batch_disparity(lefts, rights, _BATCH_CFG, mesh=None)
        for r in _job(ranks, "batch"):
            np.testing.assert_allclose(r["disp"], np.asarray(d_ref), atol=1e-5)
            np.testing.assert_array_equal(r["valid"], np.asarray(v_ref))


class TestShardedVoxel:
    def test_matches_single_device(self, ranks):
        pts, cols, val = map(jnp.asarray, _cloud_arrays(2))
        ref = jvoxel_downsample(JPointCloud(pts, cols, val), voxel_size=1.0, bounds=64.0)
        ref_pts, _ = _valid_points(ref)
        for r in _job(ranks, "voxel"):
            out_pts, _ = _valid_points(r)
            assert len(out_pts) == len(ref_pts)
            np.testing.assert_allclose(out_pts, ref_pts, atol=1e-4)


class TestVoxelRouteMerge:
    def test_matches_global_downsample(self, ranks):
        pts, cols, val = map(jnp.asarray, _cloud_arrays(5))
        ref = jvoxel_downsample(JPointCloud(pts, cols, val), voxel_size=1.0, bounds=64.0)
        ref_pts, ref_cols = _valid_points(ref)
        for r in _job(ranks, "route"):
            assert int(r["dropped"]) == 0   # the default bucket capacity is lossless
            out_pts, out_cols = _valid_points(r)
            assert len(out_pts) == len(ref_pts)
            np.testing.assert_allclose(out_pts, ref_pts, atol=1e-4)
            np.testing.assert_allclose(out_cols, ref_cols, atol=1e-4)

    def test_overflow_counted(self, ranks):
        got = _job(ranks, "overflow")
        for r in got:
            assert int(r["dropped"]) > 0    # tiny buckets overflow and are counted
            assert int(r["dropped"]) == int(got[0]["dropped"])
            assert 0 < int(r["kept"]) <= WORLD * WORLD * 4   # 4 records a bucket


class TestShardedSGM:
    def test_row_slab_matches_monolithic(self, ranks, stereo_frame):
        d_ref, v_ref = jsgm_disparity(jnp.asarray(stereo_frame.left),
                                      jnp.asarray(stereo_frame.right), _SGM_CFG)
        ref = np.asarray(d_ref)
        for r in _job(ranks, "sgm"):
            both = np.asarray(v_ref) & r["valid"]
            exact = np.abs(ref[both] - r["disp"][both]) < 0.01
            close = np.abs(ref[both] - r["disp"][both]) <= 1.0
            assert both.mean() > 0.5
            assert exact.mean() > 0.95, f"exact agreement {exact.mean():.4f}"
            assert close.mean() > 0.995, f"1px agreement {close.mean():.4f}"

    def test_rejects_bad_geometry(self, ranks):
        for r in _job(ranks, "sgm"):
            assert "not divisible" in str(r["rejects_rows"])   # 190 % 4 != 0
            assert "must exceed halo" in str(r["rejects_halo"])  # slab 48 <= halo 48


# ---------------------------------------------------------------------------
# size 1, in process: the port's single-device forms and JAX on a mesh of one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    return tmesh.make_mesh(device="cpu")


@pytest.fixture(scope="module")
def jmesh1():
    return jmesh.make_mesh(1)


def test_make_mesh_without_a_process_group(mesh1):
    assert (mesh1.size, mesh1.rank, mesh1.group, mesh1.axis_names) == (1, 0, None, ("d",))
    assert mesh1.device == torch.device("cpu")
    with pytest.raises(ValueError, match="requested 4 devices, only 1 available"):
        tmesh.make_mesh(4, device="cpu")
    assert [tmesh.pad_to_multiple(n, 8) for n in (0, 1, 8, 33)] == [
        jmesh.pad_to_multiple(n, 8) for n in (0, 1, 8, 33)]
    x = torch.arange(6.0).reshape(3, 2)
    for fn in (tmesh.psum, tmesh.all_gather, tmesh.all_to_all):
        assert torch.equal(fn(x, mesh1), x)
    assert torch.equal(tmesh.shift(x, mesh1, 1), torch.zeros_like(x))
    assert tmesh.axis_index(mesh1) == 0


def test_pad_observations_matches_jax(problems):
    """33 observations padded for 8 and for 4 devices: every field equal to
    the reference's (pad slots invalid, pad weight 1.0, unit weights made)."""
    for n_dev in (8, 4):
        want = jba_sharded._pad_observations(problems["ba_uneven"], n_dev)
        got = ba_sharded._pad_observations(
            problem_from_numpy(problems["ba_uneven"], "cpu"), n_dev)
        assert got.obs_kf.shape[0] == tmesh.pad_to_multiple(33, n_dev)
        for name in ("obs_kf", "obs_lm", "obs_point", "obs_valid", "obs_weight"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("name", ["ba", "ba_uneven", "slot"])
def test_size1_ba_equals_single_device_and_jax(problems, mesh1, jmesh1, name):
    """One rank: the sharded solves run the same sums as ``solve_ba`` (to
    1e-6; equal order on the CPU) and agree with the reference's sharded
    solve on a mesh of one device at its tests' tolerance."""
    problem = problem_from_numpy(problems[name], "cpu")
    kw = _UNEVEN_KW if name == "ba_uneven" else _BA_KW
    if name == "slot":
        got = ba_sharded.solve_ba_slot_sharded(problem, mesh1, slot_major=32, **kw)
        single = solve_ba(problem, slot_major=32, **kw)
        want = jba_sharded.solve_ba_slot_sharded(problems[name], jmesh1, slot_major=32, **kw)
    else:
        got = ba_sharded.solve_ba_sharded(problem, mesh1, **kw)
        single = solve_ba(problem, **kw)
        want = jba_sharded.solve_ba_sharded(problems[name], jmesh1, **kw)
    for g, s in zip(got, single):
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-5)
    # atol: a noise-free bundle converges to a cost of ~1e-11, rounding residue
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-8)


def test_size1_window_event_equals_single_device(mesh1):
    cfg = port(_WINDOW_CFG)
    np.testing.assert_allclose(jobs.window_refined(cfg, mesh1),
                               jobs.window_refined(cfg, None), rtol=1e-4, atol=1e-5)


def test_size1_batch_disparity_exact(stereo_batch, mesh1):
    lefts, rights = (_t(a[:2]) for a in stereo_batch)
    cfg = port(_BATCH_CFG)
    d_m, v_m = frames.batch_disparity(lefts, rights, cfg, mesh1)
    d_0, v_0 = frames.batch_disparity(lefts, rights, cfg, None)
    assert torch.equal(d_m, d_0) and torch.equal(v_m, v_0)
    d_s, v_s = sgm_disparity(lefts[1], rights[1], cfg)
    assert torch.equal(d_m[1], d_s) and torch.equal(v_m[1], v_s)
    with pytest.raises(ValueError, match="not divisible"):
        frames.local_batch_disparity(lefts, rights, cfg,
                                     dataclasses.replace(mesh1, size=4))


def test_size1_sharded_disparity_matches_jax_mesh_of_one(stereo_frame, mesh1, jmesh1):
    """One rank pads zero halos on both sides, so the result is the
    reference's mesh-of-one result (valid masks equal, disparity within 1e-5
    px, the sgm stage test's bound), not the monolithic ``sgm_disparity``."""
    left, right = np.asarray(stereo_frame.left), np.asarray(stereo_frame.right)
    d_j, v_j = jsgm_sharded.sharded_disparity(jnp.asarray(left), jnp.asarray(right),
                                              _SGM_CFG, jmesh1, halo=16)
    d_t, v_t = sgm_sharded.sharded_disparity(_t(left), _t(right), port(_SGM_CFG), mesh1,
                                             halo=16)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    d_0, v_0 = sgm_disparity(_t(left), _t(right), port(_SGM_CFG))
    both = (v_0 & v_t).numpy()
    assert (np.abs(d_0.numpy() - d_t.numpy())[both] <= 1.0).mean() > 0.995
    assert not torch.equal(d_0, d_t)


def test_owner_hash_matches_numpy_uint32():
    """The int64-masked hash against numpy's uint32 arithmetic (the
    reference's), keys up to the largest two-word grid."""
    rng = np.random.default_rng(0)
    per_axis = 46340    # per_axis^2 just below 2^31
    hi = rng.integers(0, per_axis, 4096)
    lo = rng.integers(0, per_axis * per_axis, 4096)
    hi[:2], lo[:2] = (0, per_axis - 1), (0, per_axis * per_axis - 1)
    with np.errstate(over="ignore"):
        mix = (hi.astype(np.uint32) * np.uint32(2654435761)
               ^ lo.astype(np.uint32) * np.uint32(40503))
    key = _t(hi.astype(np.int64) * per_axis * per_axis + lo.astype(np.int64))
    for n_dev in (1, 4, 8):
        want = (mix % np.uint32(n_dev)).astype(np.int64)
        np.testing.assert_array_equal(
            voxel_sharded.owner_of(key, per_axis, n_dev).numpy(), want)


def test_size1_voxel_forms_match_single_device_and_jax(mesh1, jmesh1):
    """One rank: both sharded forms give ``voxel_downsample``'s cloud slot
    for slot (sums in the same order on the CPU: 1e-6), and the route
    merge's buckets are laid out as the reference's on a mesh of one device
    (every slot's point, color and validity, within 1e-5)."""
    pts, cols, val = _cloud_arrays(5)
    ref = voxel_downsample(PointCloud(_t(pts), _t(cols), _t(val)), 1.0, 64.0)
    down = voxel_sharded.sharded_voxel_downsample(_t(pts), _t(cols), _t(val), mesh1, 1.0, 64.0)
    routed, dropped = voxel_sharded.voxel_route_merge(_t(pts), _t(cols), _t(val), mesh1,
                                                      1.0, 64.0)
    assert int(dropped) == 0
    for got in (down, routed):
        assert torch.equal(got.valid, ref.valid)
        np.testing.assert_allclose(got.points.numpy(), ref.points.numpy(), atol=1e-6)
        np.testing.assert_allclose(got.colors.numpy(), ref.colors.numpy(), atol=1e-6)
    want, jdropped = jvoxel_sharded.voxel_route_merge(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(val), jmesh1, voxel_size=1.0,
        bounds=64.0)
    assert int(jdropped) == 0
    np.testing.assert_array_equal(routed.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(routed.points.numpy(), np.asarray(want.points), atol=1e-5)
    np.testing.assert_allclose(routed.colors.numpy(), np.asarray(want.colors), atol=1e-5)
    # a small bucket overflows in the same records on both sides
    small, d_t = voxel_sharded.voxel_route_merge(_t(pts), _t(cols), _t(val), mesh1, 1.0,
                                                 64.0, bucket_capacity=100)
    jsmall, d_j = jvoxel_sharded.voxel_route_merge(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(val), jmesh1, voxel_size=1.0,
        bounds=64.0, bucket_capacity=100)
    assert int(d_t) == int(d_j) > 0
    np.testing.assert_allclose(small.points.numpy(), np.asarray(jsmall.points), atol=1e-5)
    with pytest.raises(ValueError, match="too fine"):
        voxel_sharded.voxel_route_merge(_t(pts), _t(cols), _t(val), mesh1, 1e-3, 2048.0)
