"""PyTorch port, disparity stage: census, SGM aggregation (K1's plain
version), speckle run totals (K2's plain version), WTA, rectification and
the whole ``sgm_disparity``, each against its JAX twin on the same numpy
inputs. The Pallas forms run in interpret mode, as the JAX package's own
tests run them on the CPU. The CUDA kernels themselves are checked against
these plain versions by ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_3d_reconstruction_tpu.config import StereoConfig
from online_3d_reconstruction_tpu.stereo import census as jcensus
from online_3d_reconstruction_tpu.stereo import rectify as jrectify
from online_3d_reconstruction_tpu.stereo import sgm as jsgm
from online_3d_reconstruction_tpu.stereo import sgm_pallas as jpallas
from online_3d_reconstruction_tpu_torch.stereo import census, rectify, sgm, sgm_cuda

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfg(**kw):
    base = dict(height=192, width=256, max_disparity=32, num_paths=8,
                use_pallas=False, cost_dtype="float32")
    base.update(kw)
    return StereoConfig(**base)


class TestCensus:
    def test_codes_and_cost_volume_exact(self, stereo_frame):
        """Census codes and Hamming costs are integers: exactly equal."""
        left, right = stereo_frame.left, stereo_frame.right
        cl = np.asarray(jcensus.census_transform(jnp.asarray(left)))
        cr = np.asarray(jcensus.census_transform(jnp.asarray(right)))
        tl = census.census_transform(_t(left))
        tr = census.census_transform(_t(right))
        np.testing.assert_array_equal(tl.numpy(), cl.astype(np.int64))
        np.testing.assert_array_equal(tr.numpy(), cr.astype(np.int64))
        want = np.asarray(jcensus.cost_volume(jnp.asarray(cl), jnp.asarray(cr), 32))
        np.testing.assert_array_equal(census.cost_volume(tl, tr, 32).numpy(), want)

    def test_popcount_all_32_bits(self):
        rng = np.random.default_rng(0)
        x = rng.integers(0, 2**32, size=1000, dtype=np.uint64)
        want = np.array([bin(int(v)).count("1") for v in x])
        got = census.popcount32(_t(x.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got, want)


class TestAggregation:
    @pytest.mark.parametrize("num_paths", [2, 4, 8])
    def test_plain_bit_equal_to_scan_and_pallas(self, num_paths):
        """Integer costs, integer P1/P2: every path value is an integer, so
        the port's plain K1 equals JAX's f32 lax.scan form and the Pallas
        kernel (interpret mode) bit for bit."""
        rng = np.random.default_rng(num_paths)
        cost = rng.integers(0, 33, size=(24, 40, 16)).astype(np.float32)
        got = sgm_cuda.aggregate(_t(cost.astype(np.uint8)), 8.0, 32.0, num_paths)
        assert got.dtype == torch.float32
        scan = np.asarray(jsgm.aggregate_scan(jnp.asarray(cost), 8.0, 32.0, num_paths))
        pal = np.asarray(jpallas.aggregate_pallas(jnp.asarray(cost), 8.0, 32.0,
                                                  num_paths, interpret=True))
        np.testing.assert_array_equal(got.numpy(), scan)
        np.testing.assert_array_equal(got.numpy(), pal)

    def test_plain_matches_bruteforce_diagonals(self):
        """Literal per-pixel recurrence over all 8 directions (the JAX
        suite's diagonal oracle): fresh starts with a zero carry at every
        border the direction enters from."""
        rng = np.random.default_rng(3)
        h, w, d = 10, 12, 4
        cost = rng.integers(0, 24, size=(h, w, d)).astype(np.float32)
        p1, p2 = 8.0, 32.0

        def brute(dy, dx):
            out = np.zeros_like(cost)
            ys = range(h) if dy >= 0 else range(h - 1, -1, -1)
            xs = range(w) if dx >= 0 else range(w - 1, -1, -1)
            for y in ys:
                for x in xs:
                    py, px = y - dy, x - dx
                    if 0 <= py < h and 0 <= px < w:
                        prev = out[py, px]
                        mp = prev.min()
                        for dd in range(d):
                            c = [prev[dd], mp + p2]
                            if dd > 0:
                                c.append(prev[dd - 1] + p1)
                            if dd < d - 1:
                                c.append(prev[dd + 1] + p1)
                            out[y, x, dd] = cost[y, x, dd] + min(c) - mp
                    else:
                        out[y, x] = cost[y, x]
            return out

        gt = sum(brute(dy, dx) for dy, dx in sgm_cuda.DIRECTIONS)
        np.testing.assert_array_equal(
            sgm_cuda.aggregate_plain(_t(cost), p1, p2, 8).numpy(), gt)

    def test_rejects_bad_paths(self):
        with pytest.raises(ValueError):
            sgm_cuda.aggregate(torch.zeros((4, 4, 8), dtype=torch.uint8), 8.0, 32.0, 3)


class TestSpeckle:
    @pytest.mark.parametrize("shape", [(64, 128), (96, 256)])
    def test_mask_equal_to_xla_and_pallas(self, shape):
        """Same run-cross mass as JAX's XLA form and its Pallas kernel: the
        masks must agree bit for bit (run sums are exact f32 integers)."""
        h, w = shape
        rng = np.random.default_rng(7)
        disp = np.round(rng.uniform(0, 30, (h, w)) / 6) * 6
        disp = (disp + rng.normal(0, 0.2, (h, w))).astype(np.float32)
        valid = rng.random((h, w)) > 0.15
        got = sgm.speckle_filter(_t(disp), _t(valid), 50, 1.0).numpy()
        xla = np.asarray(jsgm.speckle_filter(jnp.asarray(disp), jnp.asarray(valid), 50, 1.0))
        pal = np.asarray(jpallas.speckle_filter_pallas(
            jnp.asarray(disp), jnp.asarray(valid), 50, 1.0, interpret=True))
        np.testing.assert_array_equal(got, xla)
        np.testing.assert_array_equal(got, pal)

    @pytest.mark.parametrize("axis", [0, 1])
    def test_run_total_plain_equals_pallas_run_total(self, axis):
        """K2's plain version against the Pallas kernel's own run-total
        function on integer values with random run starts: exact."""
        rng = np.random.default_rng(11 + axis)
        v = rng.integers(0, 40, (37, 53)).astype(np.float32)
        start = (rng.random((37, 53)) > 0.7).astype(np.float32)
        want = np.asarray(jpallas._run_total(jnp.asarray(v), jnp.asarray(start), axis))
        got = sgm_cuda.run_total(_t(v), _t(start), axis).numpy()
        np.testing.assert_array_equal(got, want)


class TestWTA:
    @pytest.mark.parametrize("fit", ["parabola", "vshape"])
    def test_wta_and_right_disparity_match_jax(self, fit):
        """Random real-valued volumes: the same f32 operations in the same
        order, so disparities agree to 1e-6 px and masks exactly."""
        rng = np.random.default_rng(5)
        agg = rng.uniform(1, 100, size=(12, 20, 16)).astype(np.float32)
        dj, vj = jsgm.wta_disparity(jnp.asarray(agg), 0.95, True, fit=fit)
        dt, vt = sgm.wta_disparity(_t(agg), 0.95, True, fit=fit)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        rj = np.asarray(jsgm.right_disparity_from_aggregated(jnp.asarray(agg)))
        np.testing.assert_array_equal(sgm.right_disparity_from_aggregated(_t(agg)).numpy(), rj)
        lj = np.asarray(jsgm.lr_consistency_mask_volume(dj, jnp.asarray(rj), 16, 1))
        np.testing.assert_array_equal(
            sgm.lr_consistency_mask_volume(dt, _t(rj), 16, 1).numpy(), lj)

    def test_unknown_fit_raises(self):
        with pytest.raises(ValueError):
            sgm.wta_disparity(torch.ones((2, 2, 8)), fit="cubic")


class TestRectify:
    def test_remap_matches_jax(self):
        """Gather-form bilinear remap, gray and RGB, with out-of-image fill
        and integer rounding. Within 1e-5: the same f32 lerp, but XLA may
        fuse its multiply-adds differently."""
        rng = np.random.default_rng(2)
        img = rng.random((30, 40)).astype(np.float32)
        rgb = rng.random((30, 40, 3)).astype(np.float32)
        mp = np.stack(np.meshgrid(np.linspace(-2, 41, 37), np.linspace(-1.5, 31, 23)),
                      axis=-1).astype(np.float32)
        mp += rng.normal(0, 0.3, mp.shape).astype(np.float32)
        for im in (img, rgb):
            want = np.asarray(jrectify.remap_bilinear(jnp.asarray(im), jnp.asarray(mp)))
            got = rectify.remap_bilinear(_t(im), _t(mp)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5)
        img8 = (img * 255).astype(np.uint8)
        want8 = np.asarray(jrectify.remap_bilinear(jnp.asarray(img8), jnp.asarray(mp)))
        got8 = rectify.remap_bilinear(_t(img8), _t(mp)).numpy()
        assert got8.dtype == np.uint8
        assert np.abs(got8.astype(int) - want8.astype(int)).max() <= 1


class TestSgmDisparity:
    @pytest.mark.parametrize("num_paths", [4, 8])
    def test_matches_jax_and_ground_truth(self, stereo_frame, num_paths):
        """Whole stage against JAX with use_pallas=False, cost_dtype=f32:
        valid masks equal, disparity within 1e-5 px (both sides compute the
        same integer volume and the same f32 subpixel fit); and the GT bars
        of the JAX chip test (density > 0.9, bad>1px < 0.02)."""
        cfg = _cfg(num_paths=num_paths)
        left, right = stereo_frame.left, stereo_frame.right
        dj, vj = jsgm.sgm_disparity(jnp.asarray(left), jnp.asarray(right), cfg)
        dt, vt = sgm.sgm_disparity(_t(left), _t(right), cfg)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
        gt = stereo_frame.gt_disparity
        ok = vt.numpy() & (gt > 0)
        assert ok.mean() > 0.9
        assert (np.abs(dt.numpy()[ok] - gt[ok]) > 1.0).mean() < 0.02
