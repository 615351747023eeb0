"""PyTorch port, disparity stage: census, the census cost volume (K4's
wrapper on the CPU, its plain chain), SGM aggregation (K1's plain
version, in f32 and in the reference's default bf16 storage), speckle run
totals (K2's plain version), the single-direction scan pair (K3's plain
version, its one-launch schedule, the skewed volumes it scans), WTA,
rectification and the whole ``sgm_disparity`` (the exact f32 path and the
bf16 one), each against its JAX twin on the same numpy inputs.
The Pallas forms run in interpret mode, as the JAX package's own tests run
them on the CPU. The CUDA kernels themselves are checked against
these plain versions by ``chip_smoke.py`` on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from online_3d_reconstruction_tpu.config import StereoConfig
from online_3d_reconstruction_tpu.stereo import census as jcensus
from online_3d_reconstruction_tpu.stereo import rectify as jrectify
from online_3d_reconstruction_tpu.stereo import sgm as jsgm
from online_3d_reconstruction_tpu.parallel import mesh as jmesh
from online_3d_reconstruction_tpu.parallel import sgm_sharded as jsgm_sharded
from online_3d_reconstruction_tpu.stereo import sgm_pallas as jpallas
from online_3d_reconstruction_tpu_torch.parallel import mesh as tmesh
from online_3d_reconstruction_tpu_torch.parallel import sgm_sharded
from online_3d_reconstruction_tpu_torch.stereo import census, rectify, sgm, sgm_cuda
from online_3d_reconstruction_tpu_torch.utils import cuda_build
from tests.test_torch_shared import port

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


class TestCensusCost:
    """``sgm_cuda.census_cost`` (K4 on the card) on CPU tensors: the plain
    chain, no launch, the reference's volume; the stage's callers go
    through it."""

    @pytest.mark.parametrize("window, d", [((5, 5), 32), ((3, 11), 16), ((7, 3), 40)])
    def test_cpu_runs_the_plain_chain(self, stereo_frame, window, d):
        left = _t(stereo_frame.left[40:80, 60:132])
        right = _t(stereo_frame.right[40:80, 60:132])
        cuda_build.reset_launch_counts()
        got = sgm_cuda.census_cost(left, right, window, d)
        assert cuda_build.launch_counts["census_cost"] == 0
        want = census.cost_volume(census.census_transform(left, window),
                                  census.census_transform(right, window), d).to(torch.uint8)
        assert got.dtype == torch.uint8 and torch.equal(got, want)
        cl = jcensus.census_transform(jnp.asarray(left.numpy()), window)
        cr = jcensus.census_transform(jnp.asarray(right.numpy()), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcensus.cost_volume(cl, cr, d)))

    @pytest.mark.parametrize("window, shape, match", [
        ((7, 7), (8, 8), ">32 bits"), ((3, 13), (8, 8), ">32 bits"),
        ((4, 5), (8, 8), "odd-sized"), ((5, 2), (8, 8), "odd-sized"),
        ((5, 5), (2, 8, 8), r"two \(H, W\) images"), ((5, 5), (8,), r"two \(H, W\) images")])
    def test_rejects_what_the_census_does_not_take(self, window, shape, match):
        with pytest.raises(ValueError, match=match):
            sgm_cuda.census_cost(torch.zeros(shape), torch.zeros(shape), window, 16)

    def test_sgm_disparity_goes_through_it(self, stereo_frame, monkeypatch):
        """One call a frame, with the configuration's window and D; the
        stage still equals the reference's (valid masks equal, disparity
        within 1e-5 px)."""
        calls = []

        def spy(left, right, window, d):
            calls.append((tuple(left.shape), tuple(window), d))
            return sgm_cuda.census_cost(left, right, window, d)

        monkeypatch.setattr(sgm, "census_cost", spy)
        cfg = _cfg(height=48, width=96, max_disparity=16)
        left = np.ascontiguousarray(stereo_frame.left[72:120, 80:176])
        right = np.ascontiguousarray(stereo_frame.right[72:120, 80:176])
        dj, vj = jsgm.sgm_disparity(jnp.asarray(left), jnp.asarray(right), cfg)
        dt, vt = sgm.sgm_disparity(_t(left), _t(right), port(cfg))
        assert calls == [((48, 96), (5, 5), 16)]
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)

    def test_sharded_stage_goes_through_it(self, stereo_frame, monkeypatch):
        """At world size 1 the sharded stage calls it once on its slab
        extended by the halo and the census radius, and equals the
        reference's mesh-of-one result (valid masks equal, disparity within
        1e-5 px)."""
        calls = []

        def spy(left, right, window, d):
            calls.append((tuple(left.shape), d))
            return sgm_cuda.census_cost(left, right, window, d)

        monkeypatch.setattr(sgm_sharded, "census_cost", spy)
        cfg = _cfg(height=64, width=96, max_disparity=16)
        left = np.ascontiguousarray(stereo_frame.left[64:128, 80:176])
        right = np.ascontiguousarray(stereo_frame.right[64:128, 80:176])
        dj, vj = jsgm_sharded.sharded_disparity(jnp.asarray(left), jnp.asarray(right), cfg,
                                                jmesh.make_mesh(1), halo=16)
        dt, vt = sgm_sharded.sharded_disparity(_t(left), _t(right), port(cfg),
                                               tmesh.make_mesh(device="cpu"), halo=16)
        assert calls == [((64 + 2 * (16 + 2), 96), 16)]
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)


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

    @pytest.mark.parametrize("num_paths", [2, 8])
    def test_aggregate_scan_under_the_reference_name(self, num_paths):
        """``sgm.aggregate_scan`` (the reference's name) on fractional costs
        and penalties: within f32 rounding of the reference's (1e-4 on sums
        of up to 8 paths of values ~50), and it rejects what that rejects."""
        rng = np.random.default_rng(10 + num_paths)
        cost = (rng.random((20, 28, 16)) * 32).astype(np.float32)
        got = sgm.aggregate_scan(_t(cost), 7.5, 30.5, num_paths)
        want = jsgm.aggregate_scan(jnp.asarray(cost), 7.5, 30.5, num_paths)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        with pytest.raises(ValueError, match="num_paths"):
            sgm.aggregate_scan(_t(cost), 8.0, 32.0, 3)

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


class TestBf16Aggregation:
    """The reference's default storage (``cost_dtype="bfloat16"``): its
    fused kernel keeps f32 carries and rounds each partial total to bf16
    where it stores it, four times."""

    @pytest.mark.parametrize("num_paths", [2, 4, 8])
    def test_plain_bit_equal_to_pallas(self, num_paths):
        """Integer costs up to 160 (sums cross 256 at every path count, so
        bf16 rounds), integer penalties: bit-equal to ``aggregate_pallas``
        in interpret mode at ``dtype=bfloat16``."""
        rng = np.random.default_rng(20 + num_paths)
        cost = rng.integers(0, 161, size=(24, 40, 16)).astype(np.float32)
        got = sgm_cuda.aggregate(_t(cost.astype(np.uint8)), 8.0, 32.0, num_paths,
                                 torch.bfloat16)
        assert got.dtype == torch.bfloat16 and got.shape == (24, 40, 16)
        want = np.asarray(jpallas.aggregate_pallas(jnp.asarray(cost), 8.0, 32.0, num_paths,
                                                   interpret=True, dtype=jnp.bfloat16))
        assert want.max() > 256
        np.testing.assert_array_equal(got.float().numpy(), want)

    def test_fractional_penalties_bit_equal_and_bf16_differs_from_f32(self):
        """Fractional penalties on census-range costs (0..32) at 8 paths: the
        f32 group sums are added in the TPU kernel's order, so the bits
        agree with no tolerance. The bf16 total differs from the exact f32
        one, so the comparison can fail: with integer penalties exactly on
        the cells whose integer sums exceed 256."""
        rng = np.random.default_rng(5)
        cost = rng.integers(0, 33, size=(24, 40, 16)).astype(np.float32)
        got = sgm_cuda.aggregate_plain(_t(cost), 7.3, 29.9, 8, torch.bfloat16)
        want = np.asarray(jpallas.aggregate_pallas(jnp.asarray(cost), 7.3, 29.9, 8,
                                                   interpret=True, dtype=jnp.bfloat16))
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert (got.float().numpy() != sgm_cuda.aggregate_plain(_t(cost), 7.3, 29.9, 8)
                .numpy()).any()
        half = sgm_cuda.aggregate_plain(_t(cost), 8.0, 32.0, 8, torch.bfloat16)
        exact = sgm_cuda.aggregate_plain(_t(cost), 8.0, 32.0, 8).numpy()
        differ = half.float().numpy() != exact
        assert differ.sum() > 0 and (exact[differ] > 256).all()

    def test_float16_plain_bit_equal_to_pallas(self):
        """``cost_dtype="float16"``, which the reference hands to ``jnp.dtype``
        as it does bfloat16: the same four roundings, to float16. Costs up
        to 255 at 8 paths, so that sums pass 2048 and fp16 rounds: bit-equal
        to ``aggregate_pallas`` in interpret mode at ``dtype=float16``."""
        rng = np.random.default_rng(28)
        cost = rng.integers(0, 256, size=(24, 40, 16)).astype(np.float32)
        got = sgm_cuda.aggregate(_t(cost.astype(np.uint8)), 8.0, 32.0, 8, torch.float16)
        assert got.dtype == torch.float16 and got.shape == (24, 40, 16)
        want = np.asarray(jpallas.aggregate_pallas(jnp.asarray(cost), 8.0, 32.0, 8,
                                                   interpret=True, dtype=jnp.float16))
        np.testing.assert_array_equal(got.float().numpy(), want)
        exact = sgm_cuda.aggregate_plain(_t(cost), 8.0, 32.0, 8).numpy()
        differ = got.float().numpy() != exact
        assert differ.sum() > 0 and (exact[differ] > 2048).all()

    def test_rejects_other_storage(self):
        """Storage that is not a floating dtype of 16 or 32 bits: refused,
        the message naming the three K1 stores."""
        cost = torch.zeros((4, 4, 8), dtype=torch.uint8)
        for fn in (sgm_cuda.aggregate, sgm_cuda.aggregate_plain):
            for dtype in (torch.int16, torch.float64):
                with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
                    fn(cost, 8.0, 32.0, 4, dtype)


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


class TestScanPair:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(37, 45, 40), (21, 13, 24)])
    def test_plain_bit_equal_to_pallas(self, shape, dtype):
        """K3's plain version against the TPU kernels (``scan_pair`` in
        interpret mode) on integer costs 0..32, in f32 and bf16 storage:
        every value is an integer below 256, so both storage types hold it
        exactly and the two must agree bit for bit. S and L are not
        multiples of the TPU kernel's 16-line or 8-sublane tiles, so its
        padding is exercised."""
        rng = np.random.default_rng(sum(shape))
        cost = rng.integers(0, 33, size=shape).astype(np.float32)
        want = jpallas.scan_pair(jnp.asarray(cost, dtype=getattr(jnp, dtype)),
                                 8.0, 32.0, interpret=True)
        got = sgm_cuda.scan_pair(_t(cost).to(getattr(torch, dtype)), 8.0, 32.0)
        assert got.dtype == getattr(torch, dtype) and got.shape == shape
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want.astype(jnp.float32)))

    def test_vertical_pair_of_aggregation(self):
        """The scan pair along axis 0 is the vertical pair of K1's 4-path
        total minus its horizontal pair."""
        rng = np.random.default_rng(2)
        cost = _t(rng.integers(0, 33, size=(19, 23, 16)).astype(np.uint8))
        four = sgm_cuda.aggregate_plain(cost, 8.0, 32.0, 4)
        two = sgm_cuda.aggregate_plain(cost, 8.0, 32.0, 2)
        np.testing.assert_array_equal(
            sgm_cuda.scan_pair(cost.to(torch.float32), 8.0, 32.0).numpy(),
            (four - two).numpy())


    def test_one_pass_alone_on_the_cpu(self):
        """``scan_launch`` on CPU tensors runs the pass's plain version, in
        place; the two passes in turn give the pair; a third name raises."""
        rng = np.random.default_rng(4)
        cost = _t(rng.integers(0, 33, size=(7, 5, 12)).astype(np.float32))
        out = torch.empty_like(cost)
        sgm_cuda.scan_launch("scan_fwd", cost, out, 8.0, 32.0)
        assert torch.equal(out, sgm_cuda.scan_fwd_plain(cost, 8.0, 32.0))
        sgm_cuda.scan_launch("scan_bwd", cost, out, 8.0, 32.0)
        assert torch.equal(out, sgm_cuda.scan_pair(cost, 8.0, 32.0))
        with pytest.raises(ValueError, match="scan_both"):
            sgm_cuda.scan_launch("scan_both", cost, out, 8.0, 32.0)
        assert cuda_build.launch_counts["scan_pair"] == 0


def _meet_in_the_middle(cost, p1, p2):
    """K3's one-launch schedule in torch, in the kernel's own order: the
    forward chain of every line takes the cells below the middle and the
    backward chain the middle and above, each stashing in f32 what the other
    will need (the forward result rounded through the storage dtype, the
    backward carry as it is); then each goes on through the other's cells,
    adds the stash it finds to its own value and stores the rounded sum."""
    s_len, dtype = cost.shape[0], cost.dtype
    c32 = cost.to(torch.float32)
    stash = torch.full(cost.shape, float("nan"), dtype=torch.float32)
    out = torch.empty_like(cost)
    first = {False: s_len // 2, True: s_len - s_len // 2}   # backward: the middle too
    cells = {False: list(range(s_len)), True: list(range(s_len - 1, -1, -1))}
    carry = {b: torch.zeros_like(c32[0]) for b in (False, True)}

    def value(backward, s):
        carry[backward] = sgm_cuda._sgm_step(carry[backward], c32[s], p1, p2)
        v = carry[backward]
        return v if backward else v.to(dtype).to(torch.float32)

    for backward in (False, True):
        for s in cells[backward][:first[backward]]:
            stash[s] = value(backward, s)
    assert not stash.isnan().any()      # every cell has had its first arrival
    for backward in (False, True):
        for s in cells[backward][first[backward]:]:
            out[s] = (value(backward, s) + stash[s]).to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_len", [1, 2, 3, 8, 9])
def test_meet_in_the_middle_schedule_equals_plain_bits(s_len, dtype):
    """First arrival stashes, second arrival sums and rounds: bit-equal to
    ``scan_pair_plain`` (round(round(fwd) + bwd)) at even and odd S and where
    one chain has no first or no second half (S = 1), on costs with
    fractions, so that both roundings of bf16 are exercised."""
    rng = np.random.default_rng(10 * s_len)
    cost = _t(rng.uniform(0, 33, size=(s_len, 5, 12)).astype(np.float32)).to(dtype)
    want = sgm_cuda.scan_pair_plain(cost, 8.0, 32.0)
    assert torch.equal(_meet_in_the_middle(cost, 8.0, 32.0), want)


class TestSkew:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("sign", [1, -1])
    def test_skew_and_deskew_equal_jax(self, sign, dtype):
        """Pad and reshape only: exactly the reference's volumes, 1e9 padding
        cells (rounded to bf16 alike) included, and back."""
        rng = np.random.default_rng(3 + sign)
        cost = rng.integers(0, 33, size=(7, 10, 4)).astype(np.float32)
        jc, tc = jnp.asarray(cost, dtype=getattr(jnp, dtype)), _t(cost).to(getattr(torch, dtype))
        want = np.asarray(jsgm._skew(jc, sign).astype(jnp.float32))
        got = sgm._skew(tc, sign)
        assert got.shape == (7, 16, 4) and got.dtype == tc.dtype
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
        assert (want == want.max()).sum() == 7 * 6 * 4 and want.max() > 9e8
        back = sgm._deskew(got, sign, 10)
        np.testing.assert_array_equal(
            back.to(torch.float32).numpy(),
            np.asarray(jsgm._deskew(jsgm._skew(jc, sign), sign, 10).astype(jnp.float32)))
        assert torch.equal(back, tc)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_scan_pair_plain_on_a_skewed_volume_equals_pallas(self, dtype):
        """K3's plain version on the volume it was kept for, (H, W + H - 1, D)
        with 1e9 padding cells, against the TPU kernels in interpret mode.
        There ``1e9 + cost`` is no exact integer (f32 ulp 64; bf16 rounds 1e9
        itself), but both sides add in the order (cost + best) - min_prev,
        so they agree bit for bit: no tolerance is needed."""
        rng = np.random.default_rng(21)
        cost = rng.integers(0, 33, size=(13, 9, 16)).astype(np.float32)
        jskew = jsgm._skew(jnp.asarray(cost, dtype=getattr(jnp, dtype)), 1)
        tskew = sgm._skew(_t(cost).to(getattr(torch, dtype)), 1)
        want = jpallas.scan_pair(jskew, 8.0, 32.0, interpret=True)
        got = sgm_cuda.scan_pair(tskew.contiguous(), 8.0, 32.0)
        assert got.shape == (13, 21, 16)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want.astype(jnp.float32)))

    @pytest.mark.parametrize("sign", [1, -1])
    def test_diagonal_round_trip_is_exact_with_zero_padding(self, sign):
        """skew, scan pair, deskew is the diagonal pair of the aggregation:
        with zero padding cells bit for bit (a zero carry over zero costs
        stays zero, a fresh start at the border). The reference's 1e9 cells
        leave (cost + 1e9) - 1e9 = 0 for the cost of the first real cell of
        a path that enters from the side, so that form is only within P2 per
        direction (the spread of a path's values above its cost)."""
        rng = np.random.default_rng(8)
        cost = _t(rng.integers(0, 33, size=(11, 14, 8)).astype(np.float32))
        want = (sgm_cuda._scan_path(cost, 8.0, 32.0, False, shift=sign)
                + sgm_cuda._scan_path(cost, 8.0, 32.0, True, shift=sign))

        def diagonal(fill):
            skewed = sgm._skew(cost, sign, fill=fill).contiguous()
            return sgm._deskew(sgm_cuda.scan_pair(skewed, 8.0, 32.0), sign, 14)

        assert torch.equal(diagonal(0.0), want)
        loose = diagonal(1e9)
        assert not torch.equal(loose, want)
        assert float((loose - want).abs().max()) <= 2 * 32.0

    def test_v2_composition_equals_the_8_path_aggregation(self):
        """Vertical + horizontal + two diagonals, each one ``scan_pair``
        (the diagonals through ``_skew`` / ``_deskew`` with zero padding),
        is ``aggregate_plain(..., 8)`` bit for bit on integer costs."""
        rng = np.random.default_rng(12)
        cost = _t(rng.integers(0, 33, size=(9, 13, 8)).astype(np.float32))
        total = sgm_cuda.scan_pair(cost, 8.0, 32.0)
        total = total + sgm_cuda.scan_pair(cost.transpose(0, 1).contiguous(),
                                           8.0, 32.0).transpose(0, 1)
        for sign in (1, -1):
            skewed = sgm._skew(cost, sign, fill=0.0).contiguous()
            total = total + sgm._deskew(sgm_cuda.scan_pair(skewed, 8.0, 32.0), sign, 13)
        assert torch.equal(total, sgm_cuda.aggregate_plain(cost, 8.0, 32.0, 8))

    def test_lr_consistency_mask_equals_jax(self):
        rng = np.random.default_rng(6)
        disp = rng.uniform(-2, 20, size=(9, 24)).astype(np.float32)
        disp[0, :4] = [0.5, 1.5, 2.5, 30.0]     # ties of the rounding, out of image
        right = np.round(rng.uniform(0, 20, size=(9, 24))).astype(np.float32)
        for max_diff in (1, 3):
            want = np.asarray(jsgm.lr_consistency_mask(jnp.asarray(disp), jnp.asarray(right),
                                                       max_diff))
            got = sgm.lr_consistency_mask(_t(disp), _t(right), max_diff)
            np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size


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

    @pytest.mark.parametrize("fit", ["parabola", "vshape"])
    def test_wta_and_right_disparity_on_a_bf16_volume_match_jax(self, fit):
        """A bf16 volume with many ties (integers 200..600 rounded to bf16):
        the reductions on bf16, their values in f32 before the ratio and the
        subpixel fit, the first index on ties, as the reference: masks and
        right disparities exactly, disparities to 1e-6 px."""
        rng = np.random.default_rng(9)
        agg = rng.integers(200, 601, size=(12, 20, 16)).astype(np.float32)
        jagg = jnp.asarray(agg, dtype=jnp.bfloat16)
        tagg = _t(agg).to(torch.bfloat16)
        assert (np.asarray(jagg.astype(jnp.float32)) == tagg.float().numpy()).all()
        dj, vj = jsgm.wta_disparity(jagg, 0.95, True, fit=fit)
        dt, vt = sgm.wta_disparity(tagg, 0.95, True, fit=fit)
        assert dt.dtype == torch.float32
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        rj = np.asarray(jsgm.right_disparity_from_aggregated(jagg))
        np.testing.assert_array_equal(sgm.right_disparity_from_aggregated(tagg).numpy(), rj)

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


def _hold_against_pallas_interpret(stereo_frame, cfg, dtype):
    """``sgm_disparity`` on a 48x96 crop against the reference's with its
    Pallas kernels in interpret mode, the aggregation stored in ``dtype``:
    valid masks equal, disparity within 1e-6 px."""
    assert sgm.aggregation_dtype(port(cfg)) == dtype
    left = np.ascontiguousarray(stereo_frame.left[72:120, 80:176])
    right = np.ascontiguousarray(stereo_frame.right[72:120, 80:176])
    dj, vj = jsgm.sgm_disparity(jnp.asarray(left), jnp.asarray(right), cfg,
                                interpret_pallas=True)
    dt, vt = sgm.sgm_disparity(_t(left), _t(right), port(cfg))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    assert vt.numpy().mean() > 0.5


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
        dt, vt = sgm.sgm_disparity(_t(left), _t(right), port(cfg))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
        gt = stereo_frame.gt_disparity
        ok = vt.numpy() & (gt > 0)
        assert ok.mean() > 0.9
        assert (np.abs(dt.numpy()[ok] - gt[ok]) > 1.0).mean() < 0.02

    def test_bf16_default_matches_jax_pallas_interpret(self, stereo_frame):
        """The defaults (``use_pallas=True``, ``cost_dtype="bfloat16"``), 8
        paths, on a 48x96 crop at D = 16 against the reference's
        ``sgm_disparity`` with its Pallas kernels in interpret mode: valid
        masks equal, disparity within 1e-6 px (the same bf16 volume, the
        same f32 subpixel arithmetic)."""
        cfg = StereoConfig(height=48, width=96, max_disparity=16, num_paths=8)
        assert cfg.use_pallas and cfg.cost_dtype == "bfloat16"
        _hold_against_pallas_interpret(stereo_frame, cfg, torch.bfloat16)

    def test_float16_matches_jax_pallas_interpret(self, stereo_frame):
        """``cost_dtype="float16"`` under ``use_pallas``, as the bfloat16
        case: the same float16 volume as the reference's Pallas kernels in
        interpret mode, so the same masks and disparity within 1e-6 px."""
        cfg = StereoConfig(height=48, width=96, max_disparity=16, num_paths=8,
                           cost_dtype="float16")
        _hold_against_pallas_interpret(stereo_frame, cfg, torch.float16)

    def test_exact_without_pallas_whatever_the_storage(self, stereo_frame):
        """``use_pallas=False`` takes the exact f32 aggregation with either
        ``cost_dtype``, as the reference's ``lax.scan`` path does: the port
        gives the f32 configuration's result and the reference's."""
        cfg = StereoConfig(height=48, width=96, max_disparity=16, num_paths=8,
                           use_pallas=False, cost_dtype="bfloat16")
        assert sgm.aggregation_dtype(port(cfg)) == torch.float32
        left = np.ascontiguousarray(stereo_frame.left[72:120, 80:176])
        right = np.ascontiguousarray(stereo_frame.right[72:120, 80:176])
        dt, vt = sgm.sgm_disparity(_t(left), _t(right), port(cfg))
        d32, v32 = sgm.sgm_disparity(_t(left), _t(right),
                                     port(dataclasses.replace(cfg, cost_dtype="float32")))
        assert torch.equal(dt, d32) and torch.equal(vt, v32)
        dj, vj = jsgm.sgm_disparity(jnp.asarray(left), jnp.asarray(right), cfg)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)

    def test_unsupported_cost_dtype_raises(self):
        cfg = port(_cfg(use_pallas=True, cost_dtype="int8"))
        for use_pallas in (True, False):
            bad = dataclasses.replace(cfg, use_pallas=use_pallas)
            with pytest.raises(ValueError, match="float32.*bfloat16.*float16"):
                sgm.aggregation_dtype(bad)
        img = torch.zeros((8, 16))
        with pytest.raises(ValueError, match="cost_dtype"):
            sgm.sgm_disparity(img, img, dataclasses.replace(
                cfg, height=8, width=16, max_disparity=8))


# ---------------------------------------------------------------------------
# what the redesigned K1 and K2 keep on the host, and the properties their
# device code rests on (the kernels themselves run only on the card)
# ---------------------------------------------------------------------------

def _line_contributions(cost, p1, p2, table):
    """K1's walk in numpy: for each scan line of ``table`` the recurrence
    from a zero carry; returns [(pixels (len,), values (len, D)), ...]."""
    h, w, d = cost.shape
    flat = cost.reshape(h * w, d).astype(np.float32)
    out = []
    for first, step, length, _ in table:
        pixels = first + step * np.arange(length)
        carry = np.zeros(d, np.float32)
        values = np.empty((length, d), np.float32)
        for s, p in enumerate(pixels):
            m = carry.min()
            dm = np.concatenate([[np.float32(1e9)], carry[:-1]]) + np.float32(p1)
            dp = np.concatenate([carry[1:], [np.float32(1e9)]]) + np.float32(p1)
            best = np.minimum(np.minimum(carry, m + np.float32(p2)), np.minimum(dm, dp))
            carry = flat[p] + best - m
            values[s] = carry
        out.append((pixels, values))
    return out


class TestLineTable:
    @pytest.mark.parametrize("shape", [(384, 512), (37, 45), (70, 33)])
    @pytest.mark.parametrize("num_paths", [2, 4, 8])
    def test_covers_every_pixel_once_per_direction_longest_first(self, shape, num_paths):
        h, w = shape
        table, offsets = sgm_cuda.line_table(h, w, num_paths)
        assert table.dtype == np.int32 and table.shape[1] == 4
        assert len(offsets) == num_paths + 1 and offsets[-1] == len(table)
        for k, (dy, dx) in enumerate(sgm_cuda.DIRECTIONS[:num_paths]):
            lines = table[offsets[k]:offsets[k + 1]].astype(np.int64)
            want = h if dy == 0 else (w if dx == 0 else h + w - 1)
            assert len(lines) == want
            assert (lines[:, 3] == k).all() and (lines[:, 1] == dy * w + dx).all()
            assert (np.diff(lines[:, 2]) <= 0).all(), "longest first"
            y0, x0 = np.divmod(lines[:, 0], w)
            y1, x1 = y0 + dy * (lines[:, 2] - 1), x0 + dx * (lines[:, 2] - 1)
            assert ((0 <= y1) & (y1 < h) & (0 <= x1) & (x1 < w)).all()
            # a line starts on the edge it enters from and ends on one it leaves by
            before = (0 <= y0 - dy) & (y0 - dy < h) & (0 <= x0 - dx) & (x0 - dx < w)
            after = (0 <= y1 + dy) & (y1 + dy < h) & (0 <= x1 + dx) & (x1 + dx < w)
            assert not before.any() and not after.any()
            seen = np.zeros(h * w, np.int64)
            ends = np.cumsum(lines[:, 2])
            which = np.repeat(np.arange(len(lines)), lines[:, 2])
            step_in_line = np.arange(ends[-1]) - np.repeat(ends - lines[:, 2], lines[:, 2])
            np.add.at(seen, lines[which, 0] + lines[which, 1] * step_in_line, 1)
            assert (seen == 1).all()
        merged = sgm_cuda.longest_first(table)
        assert (np.diff(merged[:, 2].astype(np.int64)) <= 0).all()
        assert sorted(map(tuple, merged)) == sorted(map(tuple, table))

    def test_rejects_bad_paths_and_picks_the_mode(self):
        with pytest.raises(ValueError, match="num_paths"):
            sgm_cuda.line_table(8, 8, 3)
        assert sgm_cuda.sums_fit_16_bits(8.0, 32.0, 8)
        assert sgm_cuda.sums_fit_16_bits(0, 120, 2)
        assert sgm_cuda.sums_fit_16_bits(8.0, 7936.0, 8)       # 8 * 8191 = 65528
        assert not sgm_cuda.sums_fit_16_bits(8.0, 7937.0, 8)   # 8 * 8192 = 65536
        assert not sgm_cuda.sums_fit_16_bits(7.5, 30.5, 8)
        assert not sgm_cuda.sums_fit_16_bits(8.0, 32.5, 8)
        assert not sgm_cuda.sums_fit_16_bits(-1.0, 32.0, 8)


@settings(max_examples=12, deadline=None)
@given(h=st.integers(1, 9), w=st.integers(1, 9), d=st.sampled_from([8, 16]),
       num_paths=st.sampled_from([2, 4, 8]), p1=st.integers(0, 12), p2=st.integers(0, 40),
       seed=st.integers(0, 2**16))
def test_lines_summed_in_any_order_equal_plain_bits(h, w, d, num_paths, p1, p2, seed):
    """The property K1's unordered accumulation rests on: with integer
    costs and integer P1, P2, walking every line of the table from a zero
    carry and adding the lines' values into the total in a shuffled order
    gives ``aggregate_plain`` bit for bit."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 33, (h, w, d)).astype(np.uint8)
    table, _ = sgm_cuda.line_table(h, w, num_paths)
    parts = _line_contributions(cost, p1, p2, table)
    total = np.zeros((h * w, d), np.float32)
    for i in rng.permutation(len(parts)):
        pixels, values = parts[i]
        order = rng.permutation(len(pixels))
        total[pixels[order]] += values[order]
    want = sgm_cuda.aggregate_plain(_t(cost), float(p1), float(p2), num_paths).numpy()
    np.testing.assert_array_equal(total.reshape(h, w, d), want)


def test_lines_with_fractional_penalties_close_to_plain():
    """Non-integer penalties (K1's ordered mode): the per-line walk summed
    direction by direction is within f32 rounding (1e-5 relative) of
    ``aggregate_plain``, which sums the directions in pairs."""
    rng = np.random.default_rng(3)
    cost = rng.integers(0, 33, (7, 9, 16)).astype(np.uint8)
    table, _ = sgm_cuda.line_table(7, 9, 8)
    total = np.zeros((63, 16), np.float32)
    for pixels, values in _line_contributions(cost, 7.5, 30.5, table):
        total[pixels] += values
    want = sgm_cuda.aggregate_plain(_t(cost), 7.5, 30.5, 8).numpy()
    np.testing.assert_allclose(total.reshape(7, 9, 16), want, rtol=1e-5)


def _combine(a, b):
    """K2's associative operator on (sum, flag): b after a."""
    return (b[0] if b[1] else a[0] + b[0], a[1] or b[1])


def _scan_pieces(v, flags, cuts, carry_in):
    """Inclusive segmented sums of one line cut into pieces at ``cuts``, the
    way K2 does it: each piece is walked serially to its (sum, flag) total,
    the totals are scanned with ``_combine`` (seeded with ``carry_in``) to
    the carry entering each piece, and each piece is walked again from its
    carry. Returns (values, (sum, flag) of the whole line)."""
    bounds = [0, *cuts, len(v)]
    pieces = list(zip(bounds[:-1], bounds[1:]))
    totals = []
    for a, b in pieces:
        acc = torch.zeros(())
        for i in range(a, b):
            acc = v[i] if flags[i] else acc + v[i]
        totals.append((acc, bool(flags[a:b].any())))
    out = torch.empty_like(v)
    running = (carry_in, False)
    for (a, b), total in zip(pieces, totals):
        acc = running[0]
        for i in range(a, b):
            acc = v[i] if flags[i] else acc + v[i]
            out[i] = acc
        running = _combine(running, total)
    return out, running


def _run_total_by_pieces(v, start, cuts, tile_cuts=()):
    """One line's run totals from pieces (and, with ``tile_cuts``, from
    tiles of pieces, K2's two levels): fwd + bwd - v."""
    n = len(v)
    starts = start > 0.5
    ends = torch.cat([starts[1:], torch.ones(1, dtype=torch.bool)])

    def scan(vals, flags):
        tiles = [0, *tile_cuts, n]
        carries, running = [], (torch.zeros(()), False)
        for a, b in zip(tiles[:-1], tiles[1:]):      # pass 1: tile totals
            carries.append(running[0])
            inner = [c - a for c in cuts if a < c < b]
            running = _combine(running, _scan_pieces(vals[a:b], flags[a:b], inner,
                                                     torch.zeros(()))[1])
        out = torch.empty_like(vals)
        for (a, b), carry in zip(zip(tiles[:-1], tiles[1:]), carries):   # pass 2
            inner = [c - a for c in cuts if a < c < b]
            out[a:b] = _scan_pieces(vals[a:b], flags[a:b], inner, carry)[0]
        return out

    fwd = scan(v, starts)
    bwd = scan(v.flip(0), ends.flip(0)).flip(0)
    return fwd + bwd - v


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 70), seed=st.integers(0, 2**16), density=st.floats(0.0, 1.0),
       two_level=st.booleans())
def test_segmented_operator_reproduces_run_total_plain(n, seed, density, two_level):
    """A line split at arbitrary points, each piece reduced to (sum, flag)
    and the pieces combined with K2's operator, gives ``run_total_plain``
    bit for bit on random flags; also through two levels (tiles of pieces)."""
    rng = np.random.default_rng(seed)
    v = _t(rng.integers(0, 5, n).astype(np.float32))
    start = _t((rng.random(n) < density).astype(np.float32))
    cuts = sorted(set(rng.integers(1, n, rng.integers(0, 8)).tolist())) if n > 1 else []
    tile_cuts = cuts[1::3] if two_level else ()
    got = _run_total_by_pieces(v, start, cuts, tile_cuts)
    want = sgm_cuda.run_total_plain(v[None], start[None], axis=1)[0]
    assert torch.equal(got, want)
    want_col = sgm_cuda.run_total_plain(v[:, None], start[:, None], axis=0)[:, 0]
    assert torch.equal(got, want_col)


def test_run_total_rejects_lines_longer_than_the_kernel_takes():
    v = torch.zeros((2, 16385), device="meta")
    with pytest.raises(ValueError, match="device"):
        sgm_cuda.run_total(v, v, 1)
    assert sgm_cuda._RUN_TOTAL_MAX_LINE == 32 * 512
