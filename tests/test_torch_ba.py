"""PyTorch port, window bundle adjustment: ba/problem, ba/schur,
ba/testing, ba/device_tracks and ba/window against their JAX twins on the
same inputs (the reference's problems carried over by
``problem_from_numpy`` / ``window_from_numpy``), and mirrors of the JAX BA
suite's own checks (tests/test_ba.py, tests/test_device_ba.py) on the port.

Tolerances: both sides compute in f32 and sum in other orders (the
reference's one-hot matmuls and scans, the port's scatter-adds and
matmuls), so float results agree to a few ulps of the largest term, stated
per test as relative bounds; integer results (landmark ids, masks, counts)
are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu.ba import device_tracks as jdt
from online_3d_reconstruction_tpu.ba import problem as jprob
from online_3d_reconstruction_tpu.ba import schur as jschur
from online_3d_reconstruction_tpu.ba.testing import make_synthetic_bundle as jbundle
from online_3d_reconstruction_tpu.ba.window import WindowBA as JWindowBA
from online_3d_reconstruction_tpu.config import BAConfig
from online_3d_reconstruction_tpu.geometry import se3 as jse3
from online_3d_reconstruction_tpu_torch.ba import device_tracks, problem, schur
from online_3d_reconstruction_tpu_torch.ba.problem import problem_from_numpy
from online_3d_reconstruction_tpu_torch.ba.testing import make_synthetic_bundle
from online_3d_reconstruction_tpu_torch.ba.window import WindowBA
from online_3d_reconstruction_tpu_torch.geometry import se3
from tests.test_device_ba import _chain_scenario
from tests.test_torch_shared import port

torch.set_num_threads(2)

_NOISE = jprob.StereoNoiseModel(fx=300.0, fy=300.0, baseline=0.5, sigma_px=0.5,
                                sigma_disparity=1.0)
_TNOISE = problem.StereoNoiseModel(*_NOISE)


def _close(got, want, rel):
    """Within ``rel`` of the largest magnitude of ``want`` (at least 1)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _weighted_pair(seed, **kw):
    """A reference bundle with full 3x3 information and priors, and the
    port's copy of it."""
    jp, gt, _ = jbundle(np.random.default_rng(seed), **kw)
    jp = jp._replace(obs_weight=jprob.stereo_obs_information(jp.obs_point, _NOISE),
                     priors=jnp.asarray(gt), prior_valid=jnp.ones(gt.shape[0], bool))
    return jp, problem_from_numpy(jp, "cpu")


# ---------------------------------------------------------------------------
# against the reference, function by function
# ---------------------------------------------------------------------------

def test_synthetic_bundle_matches_jax():
    """Same rng draws: integer fields equal, poses within f32 rounding of
    the retract (1e-6)."""
    for kw in (dict(w=4, l=32), dict(w=5, l=48, obs_noise=0.05, n_cap=200),
               dict(w=4, l=32, n_cap=64, obs_per_kf=16)):
        jp, jgt, jlm = jbundle(np.random.default_rng(7), **kw)
        tp, tgt, tlm = make_synthetic_bundle(np.random.default_rng(7), device="cpu", **kw)
        np.testing.assert_array_equal(tgt, jgt)
        np.testing.assert_array_equal(tlm, jlm)
        for name in ("obs_kf", "obs_lm", "obs_valid", "lm_valid"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)))
        np.testing.assert_array_equal(tp.landmarks.numpy(), np.asarray(jp.landmarks))
        np.testing.assert_array_equal(tp.obs_point.numpy(), np.asarray(jp.obs_point))
        np.testing.assert_allclose(tp.poses.numpy(), np.asarray(jp.poses), atol=1e-6)


def test_problem_terms_match_jax():
    """Residuals, Jacobians, stereo information and prior terms within 1e-6
    relative; whitened norms, Huber weights and costs within 5e-5 (the
    residuals agree to ~1e-6 m, and whitening by information weights up to
    ~1e4 turns that into ~1e-5 of a norm)."""
    jp, tp = _weighted_pair(3, w=4, l=24, obs_noise=0.05)
    _close(problem.residuals(tp.poses, tp.landmarks, tp),
           jprob.residuals(jp.poses, jp.landmarks, jp), 1e-6)
    for got, want in zip(problem.jacobians(tp.poses, tp.landmarks, tp),
                         jprob.jacobians(jp.poses, jp.landmarks, jp)):
        _close(got, want, 1e-6)
    _close(problem.stereo_obs_information(tp.obs_point, _TNOISE), jp.obs_weight, 1e-6)
    _close(problem.stereo_obs_weights(tp.obs_point, 0.01, 0.002),
           jprob.stereo_obs_weights(jp.obs_point, 0.01, 0.002), 1e-6)
    r = problem.residuals(tp.poses, tp.landmarks, tp)
    jr = jprob.residuals(jp.poses, jp.landmarks, jp)
    _close(problem.weighted_sqnorm(r, tp), jprob.weighted_sqnorm(jr, jp), 5e-5)
    _close(problem.huber_weights(r, 3.0, tp), jprob.huber_weights(jr, 3.0, jp), 5e-5)
    _close(problem.huber_weights(r, 0.05), jprob.huber_weights(jr, 0.05), 5e-5)
    for delta in (0.0, 3.0):
        _close(problem.total_cost(tp.poses, tp.landmarks, tp, delta),
               jprob.total_cost(jp.poses, jp.landmarks, jp, delta), 5e-5)
    moved = jp.poses.at[1:, :3, 3].add(0.1)
    for got, want in zip(problem.prior_residuals(_t(moved), tp),
                         jprob.prior_residuals(moved, jp)):
        _close(got, want, 1e-6)
    for got, want in zip(problem.prior_jacobians(tp.poses),
                         jprob.prior_jacobians(jp.poses)):
        _close(got, want, 1e-6)


@pytest.mark.parametrize("slot_major", [0, 16])
def test_normal_blocks_match_jax(slot_major):
    """Generic and slot-major accumulation with information weights, Huber
    and priors: every block within 5e-5 of its largest entry (information
    weights reach ~1e4, so the blocks sum terms of very different size)."""
    jp, tp = _weighted_pair(0, w=4, l=32, obs_noise=0.05, n_cap=64, obs_per_kf=16)
    kw = dict(prior_position_weight=20.0, prior_rotation_weight=100.0,
              slot_major=slot_major)
    want = jschur.accumulate_normal_blocks(jp.poses, jp.landmarks, jp, 3.0, **kw)
    got = schur.accumulate_normal_blocks(tp.poses, tp.landmarks, tp, 3.0, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 5e-5)


def test_inv3x3_and_schur_solve_match_jax():
    """The adjugate inverse within 1e-6 relative on damped SPD blocks, and
    the reduced solve (anchored and free) within 1e-4 of the step's size."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(64, 3, 3)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    _close(schur.inv3x3(torch.from_numpy(m)), jschur.inv3x3(jnp.asarray(m)), 1e-6)
    jp, tp = _weighted_pair(1, w=4, l=24, obs_noise=0.05)
    jb = jschur.accumulate_normal_blocks(jp.poses, jp.landmarks, jp, 0.0)
    tb = schur.accumulate_normal_blocks(tp.poses, tp.landmarks, tp, 0.0)
    for anchor in (True, False):
        for got, want in zip(schur.schur_solve(*tb, 1e-4, anchor),
                             jschur.schur_solve(*jb, 1e-4, anchor)):
            _close(got, want, 1e-4)


@pytest.mark.parametrize("case", ["plain", "huber", "priors_weighted"])
def test_solve_ba_matches_jax(case):
    """Whole GN solves: poses within 1e-5, landmarks within 1e-5 relative,
    cost traces within 1e-5 relative, on the reference's problems."""
    if case == "priors_weighted":
        jp, tp = _weighted_pair(5, w=5, l=48, obs_noise=0.05, n_cap=200)
        kw = dict(iters=3, damping=1e-4, huber_delta=3.0, anchor_first=False,
                  prior_position_weight=40.0, prior_rotation_weight=2500.0)
    else:
        jp, _, _ = jbundle(np.random.default_rng(3), w=5, l=48, obs_noise=0.05)
        tp = problem_from_numpy(jp, "cpu")
        kw = dict(iters=6, damping=1e-4, huber_delta=0.5 if case == "huber" else 0.0)
    want = jschur.solve_ba(jp, **kw)
    got = schur.solve_ba(tp, **kw)
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
    _close(got[2], want[2], 1e-5)


def test_solve_ba_slot_major_matches_generic():
    """The window's layout through both accumulations gives the same solve."""
    tp, _, _ = make_synthetic_bundle(np.random.default_rng(9), w=6, l=64, obs_noise=0.02,
                                     n_cap=6 * 24, obs_per_kf=24, device="cpu")
    a = schur.solve_ba(tp, iters=4, huber_delta=0.5)
    b = schur.solve_ba(tp, iters=4, huber_delta=0.5, slot_major=24)
    _close(b[0], a[0].numpy(), 1e-5)
    _close(b[2], a[2].numpy(), 1e-5)


def test_non_positive_definite_step_is_rejected(monkeypatch):
    """A reduced system that Cholesky cannot factor gives a NaN step (as the
    reference's cho_factor does) that the cost guard rejects: the poses
    stay where they were and the cost trace stays finite."""
    tp, _, _ = make_synthetic_bundle(np.random.default_rng(2), w=3, l=8, device="cpu")
    b, c, e, g_p, g_x = schur.accumulate_normal_blocks(tp.poses, tp.landmarks, tp, 0.0)
    dp, _ = schur.schur_solve(-b, c, e, g_p, g_x, 0.0, True)
    assert torch.isnan(dp).all()

    real = schur.schur_solve
    monkeypatch.setattr(schur, "schur_solve",
                        lambda *a: (torch.full_like(real(*a)[0], float("nan")),
                                    real(*a)[1]))
    poses, _, trace = schur.solve_ba(tp, iters=2)
    assert torch.equal(poses, tp.poses)
    assert torch.isfinite(trace).all() and trace[0] == trace[-1]


# ---------------------------------------------------------------------------
# mirrors of tests/test_ba.py on the port
# ---------------------------------------------------------------------------

def _retracted_cost(tp, with_prior_weight=0.0):
    def cost_fn(xi, dx):
        poses = se3.retract(tp.poses, xi)
        c = problem.total_cost(poses, tp.landmarks + dx, tp, 0.0)
        if with_prior_weight:
            r_pos, _ = problem.prior_residuals(poses, tp)
            c = c + 0.5 * with_prior_weight * (r_pos * r_pos).sum()
        return c
    return cost_fn


class TestGradients:
    def test_accumulated_gradient_matches_autograd(self):
        """g_p and g_x of the normal equations are the cost's gradient in
        the pose tangent and the landmark offset (torch.autograd)."""
        tp, _, _ = make_synthetic_bundle(np.random.default_rng(0), w=3, l=8, device="cpu")
        xi = torch.zeros((3, 6), requires_grad=True)
        dx = torch.zeros((8, 3), requires_grad=True)
        _retracted_cost(tp)(xi, dx).backward()
        _, _, _, g_p, g_x = schur.accumulate_normal_blocks(tp.poses, tp.landmarks, tp, 0.0)
        np.testing.assert_allclose(g_p.numpy(), xi.grad.numpy(), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(g_x.numpy(), dx.grad.numpy(), rtol=1e-3, atol=1e-4)


class TestSchur:
    def test_schur_equals_direct_solve(self):
        tp, _, _ = make_synthetic_bundle(np.random.default_rng(1), w=3, l=6, device="cpu")
        b, c, e, g_p, g_x = schur.accumulate_normal_blocks(tp.poses, tp.landmarks, tp, 0.0)
        damping = 1e-4
        dp, dx = schur.schur_solve(b, c, e, g_p, g_x, damping, anchor_first=True)
        w, l = 3, 6
        bb, cc, ee = b.double().numpy(), c.double().numpy(), e.double().numpy()
        h = np.zeros((6 * w + 3 * l, 6 * w + 3 * l))
        g = np.zeros(6 * w + 3 * l)
        for k in range(w):
            h[6 * k:6 * k + 6, 6 * k:6 * k + 6] = bb[k] + damping * np.eye(6)
            g[6 * k:6 * k + 6] = g_p.numpy()[k]
        for j in range(l):
            o = 6 * w + 3 * j
            h[o:o + 3, o:o + 3] = cc[j] + (damping + 1e-8) * np.eye(3)
            g[o:o + 3] = g_x.numpy()[j]
        for k in range(w):
            for j in range(l):
                o = 6 * w + 3 * j
                h[6 * k:6 * k + 6, o:o + 3] = ee[k, j]
                h[o:o + 3, 6 * k:6 * k + 6] = ee[k, j].T
        free = np.arange(6, h.shape[0])  # anchor pose 0
        sol = np.linalg.solve(h[np.ix_(free, free)], -g[free])
        np.testing.assert_allclose(dp.numpy()[0], 0.0, atol=1e-7)
        np.testing.assert_allclose(dp.numpy()[1:], sol[:6 * (w - 1)].reshape(w - 1, 6),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(dx.numpy(), sol[6 * (w - 1):].reshape(l, 3),
                                   rtol=1e-3, atol=1e-4)


class TestSolve:
    def test_recovers_ground_truth_noiseless(self):
        tp, gt_poses, _ = make_synthetic_bundle(np.random.default_rng(2), w=4, l=32, device="cpu")
        poses, _, trace = schur.solve_ba(tp, iters=8, damping=1e-6, huber_delta=0.0)
        t = trace.numpy()
        assert t[-1] < 1e-6 * max(t[0], 1.0), f"cost trace {t}"
        rel = se3.inverse(torch.from_numpy(gt_poses)) @ poses
        assert float(rel[:, :3, 3].norm(dim=-1).max()) < 1e-3
        assert float(se3.log_so3(rel[:, :3, :3]).norm(dim=-1).max()) < 1e-3

    def test_cost_monotone_under_noise(self):
        tp, _, _ = make_synthetic_bundle(np.random.default_rng(3), w=5, l=48,
                                         obs_noise=0.05, device="cpu")
        _, _, trace = schur.solve_ba(tp, iters=6, damping=1e-4, huber_delta=0.5)
        t = trace.numpy()
        assert np.all(np.diff(t) <= 1e-5), f"cost increased: {t}"
        assert t[-1] < t[0]


class TestPosePriors:
    def _with_priors(self, rng):
        tp, gt_poses, _ = make_synthetic_bundle(rng, w=3, l=8, device="cpu")
        return tp._replace(priors=torch.from_numpy(gt_poses),
                           prior_valid=torch.ones(3, dtype=torch.bool))

    def test_position_prior_gradient_matches_autograd(self):
        tp = self._with_priors(np.random.default_rng(21))
        w_pos = 7.0
        xi = torch.zeros((3, 6), requires_grad=True)
        _retracted_cost(tp, w_pos)(xi, torch.zeros((8, 3))).backward()
        _, _, _, g_p, _ = schur.accumulate_normal_blocks(
            tp.poses, tp.landmarks, tp, 0.0, prior_position_weight=w_pos)
        np.testing.assert_allclose(g_p.numpy(), xi.grad.numpy(), rtol=1e-4, atol=1e-5)

    def test_priors_only_solve_snaps_to_priors(self):
        """No visual observations: the solve must land on the priors."""
        tp = self._with_priors(np.random.default_rng(22))
        tp = tp._replace(obs_valid=torch.zeros_like(tp.obs_valid))
        poses, _, _ = schur.solve_ba(tp, iters=6, damping=1e-6, huber_delta=0.0,
                                     anchor_first=False, prior_position_weight=50.0,
                                     prior_rotation_weight=50.0)
        np.testing.assert_allclose(poses.numpy(), tp.priors.numpy(), rtol=1e-3, atol=1e-3)


class TestSlotMajorEquivalence:
    """The port's slot-major accumulation against its generic path, block
    for block, in the reference suite's four cases and tolerance."""

    def _problem(self, seed, w=4, l=32, k=16):
        tp, _, _ = make_synthetic_bundle(np.random.default_rng(seed), w=w, l=l,
                                         obs_noise=0.05, n_cap=w * k, obs_per_kf=k, device="cpu")
        return tp, k

    def _assert_blocks_match(self, tp, k, **kw):
        gen = schur.accumulate_normal_blocks(tp.poses, tp.landmarks, tp, 0.5, **kw)
        slo = schur.accumulate_normal_blocks(tp.poses, tp.landmarks, tp, 0.5,
                                             slot_major=k, **kw)
        for name, a, b in zip(("B", "C", "E", "g_p", "g_x"), gen, slo):
            scale = max(float(a.abs().max()), 1.0)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6 * scale,
                                       err_msg=f"slot-major {name} diverges")

    def test_unweighted(self):
        self._assert_blocks_match(*self._problem(0))

    def test_diagonal_weights(self):
        tp, k = self._problem(1)
        w = np.abs(np.random.default_rng(2).normal(1.0, 0.3, tuple(tp.obs_point.shape))
                   .astype(np.float32)) + 0.1
        self._assert_blocks_match(tp._replace(obs_weight=torch.from_numpy(w)), k)

    def test_full_3x3_information(self):
        tp, k = self._problem(3)
        w = problem.stereo_obs_information(tp.obs_point, _TNOISE)
        self._assert_blocks_match(tp._replace(obs_weight=w), k)

    def test_with_priors(self):
        tp, k = self._problem(4)
        pri = tp._replace(priors=tp.poses, prior_valid=torch.ones(tp.poses.shape[0],
                                                                  dtype=torch.bool))
        self._assert_blocks_match(pri, k, prior_position_weight=20.0,
                                  prior_rotation_weight=100.0)


# ---------------------------------------------------------------------------
# device window (ba/device_tracks.py) and host track table (ba/window.py)
# ---------------------------------------------------------------------------

def _t(x):
    return torch.from_numpy(np.array(x))


class TestChainRoots:
    @pytest.mark.parametrize("case", ["unbroken", "broken", "permuted"])
    def test_matches_jax(self, case):
        """The reference suite's three chain cases, and a random one, equal
        to the reference's roots."""
        if case == "unbroken":
            idx = np.tile(np.arange(8), (4, 1))
            ok = np.ones((4, 8), bool)
            ok[0] = False
        elif case == "broken":
            idx = np.tile(np.arange(4), (3, 1))
            ok = np.ones((3, 4), bool)
            ok[0] = False
            ok[1, 2] = False
        else:
            idx = np.array([[0, 1, 2, 3], [3, 2, 1, 0]])
            ok = np.array([[False] * 4, [True] * 4])
        want = np.asarray(jdt._chain_roots(jnp.asarray(idx, jnp.int32), jnp.asarray(ok)))
        np.testing.assert_array_equal(device_tracks._chain_roots(_t(idx), _t(ok)).numpy(),
                                      want)

    def test_random_links_match_jax(self):
        rng = np.random.default_rng(6)
        idx = rng.integers(0, 32, (6, 32))
        ok = rng.random((6, 32)) > 0.3
        want = np.asarray(jdt._chain_roots(jnp.asarray(idx, jnp.int32), jnp.asarray(ok)))
        np.testing.assert_array_equal(device_tracks._chain_roots(_t(idx), _t(ok)).numpy(),
                                      want)


def _ring_run(cfg, frames, priors, noise=False):
    """Both windows over the same keyframes; yields (jax state, port state,
    jax refined, port refined, jax stats, port stats) after each event."""
    js = jdt.create_window(cfg.window, len(frames[0]["valid3d"]))
    ts = device_tracks.create_window(cfg.window, len(frames[0]["valid3d"]), "cpu")
    for k, f in enumerate(frames):
        ok = f["match_ok"] if k > 0 else np.zeros_like(f["match_ok"])
        args = (f["points3d"], f["valid3d"], f["match_idx"], ok, f["pose"],
                priors[k].astype(np.float32))
        js, jr, jst = jdt.keyframe_step(js, *map(jnp.asarray, args), cfg,
                                        noise_model=_NOISE if noise else None)
        ts, tr, tst = device_tracks.keyframe_core(ts, *map(_t, args), port(cfg),
                                                  noise_model=_TNOISE if noise else None)
        yield js, ts, jr, tr, jst, tst


_COUNTS = ("landmarks", "observations", "dropped_landmarks")


class TestBuildProblem:
    @pytest.mark.parametrize("l_cap", [40, 256])
    def test_integer_outputs_equal_jax(self, l_cap):
        """Landmark ids, masks and counts exactly the reference's, with and
        without capacity overflow, on chains broken at random; landmark
        initializations within 1e-6 relative."""
        rng = np.random.default_rng(5)
        frames, _, _ = _chain_scenario(rng, n_kf=3, k_kp=64, drop_prob=0.3)
        cfg = BAConfig(window=4, max_landmarks=l_cap)
        js = jdt.create_window(4, 64)
        for k, f in enumerate(frames):
            ok = f["match_ok"] if k > 0 else np.zeros_like(f["match_ok"])
            js = jdt._append(js, *(jnp.asarray(a) for a in (
                f["points3d"], f["valid3d"], f["match_idx"], ok, f["pose"], f["pose"])))
        ts = device_tracks.window_from_numpy(js, "cpu")
        assert ts.count == 3
        jp, jst = jdt.build_problem(js, cfg.max_landmarks, _NOISE)
        tp, tst = device_tracks.build_problem(ts, cfg.max_landmarks, _TNOISE)
        for name in ("obs_kf", "obs_lm", "obs_valid", "lm_valid", "prior_valid"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)), err_msg=name)
        for name in _COUNTS:
            assert int(tst[name]) == int(jst[name]), name
        assert (int(tst["dropped_landmarks"]) > 0) == (l_cap == 40)
        _close(tp.landmarks, jp.landmarks, 1e-6)
        _close(tp.obs_weight, jp.obs_weight, 1e-6)

    def test_append_matches_jax(self):
        """The ring after appends (with link gating on 3D validity) equals
        the reference's."""
        rng = np.random.default_rng(8)
        frames, _, _ = _chain_scenario(rng, n_kf=3, k_kp=16, drop_prob=0.3)
        frames[1]["valid3d"][::3] = False
        js = jdt.create_window(4, 16)
        ts = device_tracks.create_window(4, 16, "cpu")
        for f in frames:
            args = (f["points3d"], f["valid3d"], f["match_idx"], f["match_ok"],
                    f["pose"], f["pose"])
            js = jdt._append(js, *map(jnp.asarray, args))
            ts = device_tracks._append(ts, *map(_t, args))
        for name in ("points3d", "valid3d", "match_idx", "match_ok", "poses", "priors"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
        assert ts.count == int(js.count)


class TestKeyframeCore:
    def test_shifting_ring_matches_jax(self):
        """W=4 over six keyframes, so the ring shifts twice; the product
        estimator (3x3 information, Huber, priors, capacity overflow).
        After every event: the ring, the integer stats exactly the
        reference's; refined poses within 1e-4 m (the GN solve runs on
        inputs that agree to f32 rounding)."""
        rng = np.random.default_rng(5)
        frames, gt, _ = _chain_scenario(rng, n_kf=6, k_kp=64, drop_prob=0.3)
        cfg = BAConfig(window=4, max_landmarks=40, gn_iters=3, obs_weighting=True,
                       huber_delta=3.0, prior_position_weight=1 / 0.15**2,
                       prior_rotation_weight=1 / 0.01**2)
        for js, ts, jr, tr, jst, tst in _ring_run(cfg, frames, gt, noise=True):
            assert ts.count == int(js.count)
            for name in ("valid3d", "match_idx", "match_ok"):
                np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                              np.asarray(getattr(js, name)))
            for name in _COUNTS:
                assert int(tst[name]) == int(jst[name]), name
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
        assert ts.count == 4 and int(tst["dropped_landmarks"]) > 0

    def test_refines_toward_ground_truth(self):
        rng = np.random.default_rng(7)
        frames, gt_poses, noisy_poses = _chain_scenario(rng, n_kf=3, k_kp=64)
        cfg = BAConfig(window=4, max_landmarks=128, gn_iters=6,
                       prior_position_weight=0.0, prior_rotation_weight=0.0)
        *_, refined, _, _ = list(_ring_run(cfg, frames, noisy_poses))[-1]
        for k in range(1, 3):
            before = np.linalg.norm(noisy_poses[k][:3, 3] - gt_poses[k][:3, 3])
            after = np.linalg.norm(refined.numpy()[k][:3, 3] - gt_poses[k][:3, 3])
            assert after < 0.2 * before, (k, before, after)

    def test_first_keyframe_is_noop_solve(self):
        rng = np.random.default_rng(3)
        frames, _, _ = _chain_scenario(rng, n_kf=1, k_kp=16)
        cfg = BAConfig(window=4, max_landmarks=32, gn_iters=3)
        js, ts, _, refined, _, stats = next(_ring_run(cfg, frames, [frames[0]["pose"]]))
        np.testing.assert_allclose(refined.numpy()[0], frames[0]["pose"], atol=1e-5)
        assert ts.count == 1 and int(stats["landmarks"]) == 0


class TestWindowBA:
    @pytest.mark.parametrize("noise", [False, True])
    def test_matches_jax(self, noise):
        """The host track table over four keyframes with broken chains:
        the same stats, refined poses within 1e-4 m."""
        rng = np.random.default_rng(12)
        frames, _, _ = _chain_scenario(rng, n_kf=4, k_kp=64, drop_prob=0.3)
        cfg = BAConfig(window=3, max_landmarks=48, max_obs=120, gn_iters=4,
                       huber_delta=3.0 if noise else 0.5)
        jw = JWindowBA(cfg, noise_model=_NOISE if noise else None)
        tw = WindowBA(port(cfg), noise_model=_TNOISE if noise else None, device="cpu")
        for k, f in enumerate(frames):
            kw = dict(index=k, points3d=f["points3d"], valid3d=f["valid3d"],
                      pose=f["pose"], match_index=f["match_idx"] if k else None,
                      match_valid=f["match_ok"] if k else None)
            jw.add_keyframe(**kw)
            tw.add_keyframe(**kw)
            want, got = jw.solve_window(), tw.solve_window()
            assert (want is None) == (got is None)
            if want is None:
                continue
            np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-4)
            for key in ("landmarks", "observations", "dropped_landmarks",
                        "dropped_observations", "window"):
                assert tw.last_stats[key] == jw.last_stats[key], key
        assert tw.last_stats["dropped_observations"] > 0


def test_reference_grad_agrees_with_port_autograd():
    """The reference's jax.grad of the retracted cost and the port's
    torch.autograd on the same problem: within 1e-4 relative."""
    jp, _, _ = jbundle(np.random.default_rng(0), w=3, l=8)
    tp = problem_from_numpy(jp, "cpu")

    def jcost(xi):
        poses = jax.vmap(jse3.retract)(jp.poses, xi)
        return jprob.total_cost(poses, jp.landmarks, jp, 0.0)

    want = np.asarray(jax.grad(jcost)(jnp.zeros((3, 6))))
    xi = torch.zeros((3, 6), requires_grad=True)
    _retracted_cost(tp)(xi, torch.zeros((8, 3))).backward()
    _close(xi.grad, want, 1e-4)
