"""K6 and K7, tracking's RANSAC draw and IRLS fit (``csrc/ransac_fit.cu``),
run on the CPU: g++ builds the source against ``tests/cuda_emu/cuda_emu.h``
(one OS thread per CUDA thread, barriers for the warp shuffles) and ctypes
calls the entry points through the wrappers' own launches
(``rigid.k6_launch``, ``rigid.k7_launch``).

K6: bit-equal to ``hypothesis_indices_plain`` for seeds 0, 7 and 2^32 - 1,
frame indices 0, 5 and 2^31 + 3, n 1, 3, 512 and 2000 and 1 or 128
hypotheses. K7: within float32 rounding of ``irls_fit_plain`` (T to 1e-5 x
(1 + |entry|), the weights to 1e-5 relative) on random matches with 30%
outliers at N = 517 (no multiple of the block) and with 3 valid matches;
the identity and zero weights, exactly, for zero weights; equal residuals
for collinear points (the rotation about their line is free). The
wrappers' and the entry points' refusals, and the CPU's dispatch to the
plain forms. What only the card can show (that nvcc builds them, their
times, the graph capture) stays with ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu_torch.odometry import rigid
from online_3d_reconstruction_tpu_torch.utils import cuda_build

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "online_3d_reconstruction_tpu_torch" / "csrc" / "ransac_fit.cu"
# any kernel launch: name<template args><<<blocks, threads, 0, stream>>>(
_ANY_LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?)<<<([^,]*),([^,]*),[^>]*>>>\(\s*")
_ENTRIES = ("o3r_ransac_draw", "o3r_rigid_irls")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ here to build the emulation")
    tmp = tmp_path_factory.mktemp("cuda_emu")
    (tmp / "cuda_runtime.h").write_text('#include "cuda_emu.h"\n')
    source, launches = _ANY_LAUNCH.subn(r"emu_launch(\1,\2,\3, ", SOURCE.read_text())
    assert launches == 2, launches
    (tmp / "ransac_fit.cu").write_text(source)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-x", "c++",
         "-I", str(tmp), "-I", str(ROOT / "tests" / "cuda_emu"), "-o", str(tmp / "libk67.so"),
         str(tmp / "ransac_fit.cu")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(tmp / "libk67.so"))
    for name in _ENTRIES:
        getattr(lib, name).argtypes = cuda_build.SIGNATURES[name]
    return lib


def _on_stream(entry, *args):
    return entry(*args, None)


# ---------------------------------------------------------------------------
# K6: the draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 128])
@pytest.mark.parametrize("n", [1, 3, 512, 2000])
@pytest.mark.parametrize("frame", [0, 5, 2**31 + 3])
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_emulated_k6_equals_plain_bits(emulated, seed, frame, n, iters):
    """The (iters, 3) int64 indices of the plain threefry chain, bit for
    bit, one launch counted."""
    frame_idx = torch.tensor(frame)
    before = cuda_build.launch_counts["ransac_draw"]
    got = rigid.k6_launch(emulated, _on_stream, seed, frame_idx, iters, n)
    assert cuda_build.launch_counts["ransac_draw"] == before + 1
    want = rigid.hypothesis_indices_plain(seed, frame_idx, iters, n)
    assert got.dtype == torch.int64 and got.shape == (iters, 3)
    assert torch.equal(got, want)


def test_k6_refusals(emulated):
    """The wrapper refuses an index that is no 0-dim int64, a seed or n
    outside uint32, negative iters; the entry point refuses the same and a
    multiplier that is not randint's, writing nothing; a tensor on another
    device than the CPU or CUDA is refused by the dispatcher."""
    idx = torch.tensor(5)
    for bad in (torch.tensor(5, dtype=torch.int32), torch.tensor([5]), torch.tensor(5.0)):
        with pytest.raises(ValueError):
            rigid.k6_launch(emulated, _on_stream, 0, bad, 128, 512)
    for seed, n, iters in ((-1, 512, 128), (2**32, 512, 128), (0, 0, 128),
                           (0, 2**32, 128), (0, 512, -1)):
        with pytest.raises(ValueError):
            rigid.k6_launch(emulated, _on_stream, seed, idx, iters, n)
    out = torch.full((6,), -7, dtype=torch.int64)
    for seed, n, mult, total in ((-1, 512, 0, 6), (0, 0, 0, 6), (0, 512, 512, 6),
                                 (0, 512, -1, 6), (0, 512, 0, -3), (2**32, 512, 0, 6)):
        assert emulated.o3r_ransac_draw(idx.data_ptr(), out.data_ptr(), seed, n, mult,
                                        total, None) != 0
    assert bool((out == -7).all())
    with pytest.raises(ValueError):
        rigid.hypothesis_indices(0, torch.tensor(5, device="meta"), 128, 512)
    with pytest.raises(ValueError):
        rigid.hypothesis_indices(0, 5, 128, 0, "cpu")


def test_cpu_dispatch_runs_the_plain_forms():
    """CPU tensors take the plain forms, bit for bit, and count no launch."""
    before = dict(cuda_build.launch_counts)
    got = rigid.hypothesis_indices(7, torch.tensor(5), 128, 512)
    assert torch.equal(got, rigid.hypothesis_indices_plain(7, torch.tensor(5), 128, 512))
    assert torch.equal(rigid.hypothesis_indices(7, 5, 128, 512, "cpu"), got)
    src, dst, mask, valid, w = _matches(64, 0.3, 1)
    t_got, w_got = rigid.irls_fit(src, dst, mask, valid, w, 0.5)
    t_want, w_want = rigid.irls_fit_plain(src, dst, mask, valid, w, 0.5)
    assert torch.equal(t_got, t_want) and torch.equal(w_got, w_want)
    assert cuda_build.launch_counts == before


# ---------------------------------------------------------------------------
# K7: the IRLS fit
# ---------------------------------------------------------------------------

def _rotation(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _matches(n, outliers, seed, valid_count=None):
    """``n`` matches of a survey-like scene (points 10-40 m ahead, a rigid
    motion of ~0.2 rad and ~1.5 m, 2 cm noise), ``outliers`` of them
    redrawn, a fifth invalid (or only ``valid_count`` valid), octave
    weights, and a best mask of the valid matches within 0.5 m."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.uniform(-15, 15, (n, 2)), rng.uniform(10, 40, (n, 1))], 1)
    rot = _rotation(rng, 0.2)
    dst = src @ rot.T + np.array([1.0, -0.5, 0.8]) + rng.normal(0, 0.02, (n, 3))
    bad = rng.random(n) < outliers
    dst[bad] = rng.uniform(-15, 40, (int(bad.sum()), 3))
    if valid_count is None:
        valid = rng.random(n) >= 0.2
    else:
        valid = np.zeros(n, bool)
        valid[rng.choice(np.flatnonzero(~bad), valid_count, replace=False)] = True
    w = 0.25 ** rng.integers(0, 3, n)
    mask = valid & (np.linalg.norm(src @ rot.T + np.array([1.0, -0.5, 0.8]) - dst, axis=1)
                    < 0.5)
    return (torch.from_numpy(src.astype(np.float32)), torch.from_numpy(dst.astype(np.float32)),
            torch.from_numpy(mask), torch.from_numpy(valid),
            torch.from_numpy(w.astype(np.float32)))


def _collinear(n, seed):
    """Points on one line (their rotation about it is free), matched to a
    rotated and shifted copy with 2 cm noise."""
    rng = np.random.default_rng(seed)
    src = np.array([25.0, -3.0, 20.0]) + rng.uniform(-5, 5, (n, 1)) * np.array([0.6, 0.0, 0.8])
    dst = src @ _rotation(rng, 0.3).T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.02, (n, 3))
    valid = np.ones(n, bool)
    return (torch.from_numpy(src.astype(np.float32)), torch.from_numpy(dst.astype(np.float32)),
            torch.from_numpy(valid), torch.from_numpy(valid),
            torch.from_numpy(rng.uniform(0.2, 1.0, n).astype(np.float32)))


_CASES = {
    "outliers_517": lambda: _matches(517, 0.3, 3),
    "three_valid": lambda: _matches(512, 0.3, 4, valid_count=3),
    "collinear": lambda: _collinear(200, 5),
}


def _k7(lib, *args):
    before = cuda_build.launch_counts["rigid_irls"]
    out = rigid.k7_launch(lib, _on_stream, *args)
    assert cuda_build.launch_counts["rigid_irls"] == before + 1
    return out


@pytest.mark.parametrize("case", list(_CASES))
def test_emulated_k7_matches_plain(emulated, case):
    """T within 1e-5 x (1 + |entry|) of the plain fit and a proper rigid
    transform, the weights within 1e-5 relative (the invalid matches' 0
    exactly); on collinear points the residuals within 1e-5 m instead."""
    src, dst, mask, valid, w = _CASES[case]()
    t_got, w_got = (x.numpy().astype(np.float64) for x in _k7(emulated, src, dst, mask, valid,
                                                                w, 0.5))
    t_want, w_want = (x.numpy().astype(np.float64)
                      for x in rigid.irls_fit_plain(src, dst, mask, valid, w, 0.5))
    rot = t_got[:3, :3]
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(rot) - 1.0) < 1e-5
    np.testing.assert_array_equal(t_got[3], [0.0, 0.0, 0.0, 1.0])
    if case == "collinear":
        def residual(t):
            return np.linalg.norm(src.numpy() @ t[:3, :3].T + t[:3, 3] - dst.numpy(), axis=1)
        np.testing.assert_allclose(residual(t_got), residual(t_want), rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(t_got - t_want) <= 1e-5 * (1 + np.abs(t_want))), t_got - t_want
    assert np.all(np.abs(w_got - w_want) <= 1e-5 * np.abs(w_want)), np.abs(w_got - w_want).max()
    assert np.all(w_got[~valid.numpy()] == 0.0)


def test_emulated_k7_zero_weights_give_identity(emulated):
    """No weight at all: the identity and zero weights, exactly, as the
    plain fit gives them."""
    src, dst, mask, valid, _ = _matches(300, 0.3, 6)
    zero = torch.zeros(300)
    t_got, w_got = _k7(emulated, src, dst, mask, valid, zero, 0.5)
    t_want, w_want = rigid.irls_fit_plain(src, dst, mask, valid, zero, 0.5)
    assert torch.equal(t_got, torch.eye(4)) and torch.equal(t_want, torch.eye(4))
    assert not bool(w_got.any()) and not bool(w_want.any())


def test_k7_refusals(emulated):
    """Wrong dtypes, shapes, strides or devices are refused before any
    launch; the entry point refuses a negative count."""
    src, dst, mask, valid, w = _matches(64, 0.3, 8)
    bad_cases = [
        (src.double(), dst, mask, valid, w), (src, dst, mask.float(), valid, w),
        (src, dst, mask, valid, w.half()), (src[:, :2].contiguous(), dst, mask, valid, w),
        (src, dst[:63], mask, valid, w), (src, dst, mask, valid, w[:, None]),
        (src.t().contiguous().t(), dst, mask, valid, w),
        (src, dst, mask, valid, torch.stack([w, w], 1)[:, 0]),
        (src, dst.to("meta"), mask, valid, w),
    ]
    before = cuda_build.launch_counts["rigid_irls"]
    for args in bad_cases:
        with pytest.raises(ValueError):
            rigid.k7_launch(emulated, _on_stream, *args, 0.5)
    assert cuda_build.launch_counts["rigid_irls"] == before
    out_t, out_w = torch.zeros(16), torch.zeros(64)
    assert emulated.o3r_rigid_irls(src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
                                   valid.data_ptr(), w.data_ptr(), 0.5, -1,
                                   out_t.data_ptr(), out_w.data_ptr(), None) != 0

