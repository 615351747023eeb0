"""PyTorch port, mapping: voxel downsampling and the map pool against their
JAX twins. Both sides emit voxel representatives in the same (ix, iy, iz)
key order, so maps are compared slot by slot; centroid sums are taken in
another order, hence 1e-5 m on coordinates of a few metres."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.geometry.backproject import PointCloud as JCloud
from online_3d_reconstruction_tpu.mapping import global_map as jmap
from online_3d_reconstruction_tpu.mapping import voxel as jvoxel
from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
from online_3d_reconstruction_tpu_torch.mapping import global_map, voxel

torch.set_num_threads(2)
ATOL = 1e-5


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    pts[:5] = [300.0, 0.0, 0.0]           # outside bounds=256: dropped
    cols = rng.random((n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.2
    return pts, cols, valid


def _port(pts, cols, valid):
    return PointCloud(torch.from_numpy(pts.copy()), torch.from_numpy(cols.copy()),
                      torch.from_numpy(valid.copy()))


def _jax(pts, cols, valid):
    return JCloud(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid))


def _assert_same(got_pts, got_cols, got_valid, want):
    np.testing.assert_array_equal(got_valid, np.asarray(want.valid))
    np.testing.assert_allclose(got_pts, np.asarray(want.points), atol=ATOL)
    np.testing.assert_allclose(got_cols, np.asarray(want.colors), atol=ATOL)


@pytest.mark.parametrize("voxel_size", [0.5, 1.0])
def test_voxel_downsample_matches_jax(voxel_size):
    pts, cols, valid = _cloud(0, 4000)
    want = jvoxel.voxel_downsample(_jax(pts, cols, valid), voxel_size, 256.0)
    got = voxel.voxel_downsample(_port(pts, cols, valid), voxel_size, 256.0)
    k = int(got.valid.sum())
    assert 100 < k < 4000 and bool(got.valid[:k].all())   # leading slots
    _assert_same(got.points.numpy(), got.colors.numpy(), got.valid.numpy(), want)


def test_map_insert_flush_downsample_matches_jax():
    """Three clouds into a staging pool, flush into the main pool, insert
    again, flush, then the final re-voxelization: cursors and pools equal."""
    cap, stage_cap, n = 20000, 6000, 2000
    jm, js = jmap.create_map(cap), jmap.create_map(stage_cap)
    pm, ps = global_map.create_map(cap, "cpu"), global_map.create_map(stage_cap, "cpu")
    for step in range(5):
        pts, cols, valid = _cloud(10 + step, n)
        js = jmap.insert_cloud(js, _jax(pts, cols, valid))
        global_map.insert_cloud(ps, _port(pts, cols, valid))
        assert int(ps.cursor) == int(js.cursor)
        if step in (2, 4):
            jm, js = jmap.flush_staging(jm, js, 0.5, 256.0)
            pm, ps = global_map.flush_staging(pm, ps, 0.5, 256.0)
            assert int(pm.cursor) == int(jm.cursor)
            assert int(ps.cursor) == 0 and not bool(ps.valid.any())
            _assert_same(pm.points.numpy(), pm.colors.numpy(), pm.valid.numpy(), jm)
    jm = jmap.downsample_map(jm, 0.5, 256.0)
    pm = global_map.downsample_map(pm, 0.5, 256.0)
    assert int(pm.cursor) == int(jm.cursor)
    _assert_same(pm.points.numpy(), pm.colors.numpy(), pm.valid.numpy(), jm)
    got_pts, _ = global_map.map_to_numpy(pm)
    want_pts, _ = jmap.map_to_numpy(jm)
    np.testing.assert_allclose(got_pts, want_pts, atol=ATOL)


def test_needs_downsample_matches_jax():
    """True exactly when the next insert would hit the capacity clamp."""
    pts, cols, valid = _cloud(4, 40)
    jm, tm = jmap.create_map(100), global_map.create_map(100, "cpu")
    for _ in range(3):
        assert bool(global_map.needs_downsample(tm, 40)) == bool(jmap.needs_downsample(jm, 40))
        assert bool(global_map.needs_downsample(tm, 10)) == bool(jmap.needs_downsample(jm, 10))
        jm = jmap.insert_cloud(jm, _jax(pts, cols, valid))
        tm = global_map.insert_cloud(tm, _port(pts, cols, valid))
        assert int(tm.cursor) == int(jm.cursor)
    assert bool(global_map.needs_downsample(tm, 1)) and bool(jmap.needs_downsample(jm, 1))
