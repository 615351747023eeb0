"""K1's, K3's, K4's and K5's CUDA sources themselves, run on the CPU:
``tests/cuda_emu/cuda_emu.h`` stands in for the CUDA runtime (one OS thread
per CUDA thread, barriers for the warp shuffles, real atomics for the
reductions), g++ builds ``csrc/sgm_aggregate.cu``, ``csrc/sgm_scan_pair.cu``
(with its bfloat16 unit), ``csrc/census_cost.cu`` and ``csrc/voxel_reduce.cu``
against it, and ctypes calls the same entry points the port binds.

K1: every storage form (float32, and the half form in bfloat16 and
float16), through the wrapper's own launch sequence (``sgm_cuda.k1_launches``),
at 2, 4 and 8 paths, every lane split, with integer penalties (the packed
launches; the half form's row pairs meeting in the middle and its 32-bit
accumulator), at the half form's bound and one past it with costs up to 255
and on a volume that fills every field of its accumulator, integer
penalties too large to pack and fractional ones (the ordered launches), on
costs whose sums cross 256, so that bf16 rounds (fp16 rounds above 2048):
bit-equal to ``aggregate_plain`` except the f32 form with fractional
penalties, which adds the directions in another order (within f32
rounding). K3: each pass alone and the one-launch pair bit-equal to the
plain versions, at every lane split (D from 1 to 200), in the vector and the
element-by-element form, through the branch-free steady loop and the last
turns, at S = 1, 2 and odd S, with fewer lines than a warp's chains, and on
a skewed volume with 1e9 padding cells. K4: the volume bit-equal to
``census_cost_plain`` at odd shapes, one tile and several (the last one
ragged), D a multiple of 16 (the 16-byte stores) and not, D > W, the 5x5
window (its compare loop unrolled) and others (3x3, 7x3, and 3x11, which
sets bit 31), a volume off 16 bytes, on images quantised to 1/255 with flat
patches (ties give 0 bits) at the borders (replicated). K5, through the
wrapper's launch sequence (``voxel.k5_launches``): centroids, colors and
validity bit-equal to ``voxel_downsample_plain`` on pools mostly invalid,
all invalid, with points out of the grid, runs of 1 to 700 points and a
length no multiple of the block, every output slot written; at EuRoC's
2.5 cm grid its keys are the card's (the float32 reciprocal), the plain
reduction's bits given them; the wrapper's and the entries' refusals. What
only the card can show (that nvcc builds them, their times) stays with ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from online_3d_reconstruction_tpu_torch.geometry.backproject import PointCloud
from online_3d_reconstruction_tpu_torch.mapping import voxel
from online_3d_reconstruction_tpu_torch.stereo import sgm, sgm_cuda
from online_3d_reconstruction_tpu_torch.utils import cuda_build

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "online_3d_reconstruction_tpu_torch" / "csrc"
_LAUNCH = re.compile(r"(scan_kernel<[^<>]*>)<<<([^,]*),([^,]*),[^>]*>>>\(\s*")
# any kernel launch: name<template args><<<blocks, threads, 0, stream>>>(
_ANY_LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?)<<<([^,]*),([^,]*),[^>]*>>>\(\s*")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _emu_dir(tmp_path_factory):
    """g++ and a directory whose CUDA headers are the emulator."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ here to build the emulation")
    tmp = tmp_path_factory.mktemp("cuda_emu")
    for header in ("cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h"):
        (tmp / header).write_text('#include "cuda_emu.h"\n')
    return gxx, tmp


@pytest.fixture(scope="module")
def emulated_k1(tmp_path_factory):
    gxx, tmp = _emu_dir(tmp_path_factory)
    source, launches = _ANY_LAUNCH.subn(r"emu_launch(\1,\2,\3, ",
                                        (CSRC / "sgm_aggregate.cu").read_text())
    assert launches == 8, launches
    (tmp / "sgm_aggregate.cu").write_text(source)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-x", "c++",
         "-I", str(tmp), "-I", str(ROOT / "tests" / "cuda_emu"), "-o", str(tmp / "libk1.so"),
         str(tmp / "sgm_aggregate.cu")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cuda_build.bind(ctypes.CDLL(str(tmp / "libk1.so")))


def _k1(lib, cost, p1, p2, num_paths, dtype):
    """The card's launch sequence for ``aggregate`` on the emulated kernels."""
    h, w, d = cost.shape
    return sgm_cuda.k1_launches(lib, lambda entry, *args: entry(*args, None), cost,
                                p1, p2, num_paths, dtype,
                                sgm_cuda._device_tables(h, w, num_paths, cost.device))


# (H, W, D) at each lane split of K1: 2, 4, 8, 16 and 32 lanes of 4
# disparities a line, and 32 lanes of 8; lines longer than the prefetch ring;
# odd and even widths (the row pairs' middle), 2H not a multiple of 32 (the
# row-pair section filled with empty lines); rows and columns long enough
# for whole turns of the half form's steady loop (16 steps a part)
_K1_SHAPES = [(9, 13, 8), (10, 7, 16), (6, 11, 32), (5, 9, 64), (4, 6, 128), (3, 5, 256),
              (3, 41, 16), (37, 4, 32)]
_K1_DTYPES = dict(argvalues=[torch.float32, torch.bfloat16, torch.float16],
                  ids=["f32", "bf16", "fp16"])
_HALF = dict(argvalues=[torch.bfloat16, torch.float16], ids=["bf16", "fp16"])


def _half_launches(num_paths):
    """The half form's launches within its bound: the line launch and the
    finishing one, or the line launch alone with 2 paths."""
    return 1 if num_paths == 2 else 2


@pytest.mark.parametrize("dtype", **_K1_DTYPES)
@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_emulated_k1_equals_plain_bits(emulated_k1, num_paths, dtype):
    """Integer penalties: the packed launches (all directions in one, then
    the widening, or the half form's last two roundings) give
    ``aggregate_plain``'s bits at every lane split; costs up to 160 make the
    sums cross 256."""
    for shape in _K1_SHAPES:
        rng = np.random.default_rng(sum(shape) + num_paths)
        cost = torch.from_numpy(rng.integers(0, 161, size=shape).astype(np.uint8))
        if dtype == torch.float32:
            assert sgm_cuda.sums_fit_16_bits(8.0, 32.0, num_paths)
        else:
            assert sgm_cuda.groups_fit_32_bits(8.0, 32.0, num_paths)
        sgm_cuda.reset_launch_counts()
        got = _k1(emulated_k1, cost, 8.0, 32.0, num_paths, dtype)
        assert sgm_cuda.launch_counts["sgm_path"] == (
            2 if dtype == torch.float32 else _half_launches(num_paths))
        want = sgm_cuda.aggregate_plain(cost, 8.0, 32.0, num_paths, dtype)
        assert got.dtype == dtype and torch.equal(got, want), shape
    if dtype == torch.bfloat16:
        assert not torch.equal(want.float(), sgm_cuda.aggregate_plain(cost, 8.0, 32.0,
                                                                      num_paths))


@pytest.mark.parametrize("dtype", **_K1_DTYPES)
@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_emulated_k1_ordered_launches(emulated_k1, num_paths, dtype):
    """Penalties the packed launches do not take, launched direction by
    direction: integer ones too large to pack give the plain bits in every
    form; fractional ones the plain bits in the half forms (the TPU
    kernel's order of additions and its roundings) and within f32 rounding
    in f32 (1e-6 relative: the plain version adds the directions in pairs),
    the same in two runs."""
    rng = np.random.default_rng(40 + num_paths)
    cost = torch.from_numpy(rng.integers(0, 161, size=(7, 10, 16)).astype(np.uint8))
    assert not sgm_cuda.sums_fit_16_bits(8.0, 70000.0, num_paths)
    assert not sgm_cuda.groups_fit_32_bits(8.0, 70000.0, num_paths)
    got = _k1(emulated_k1, cost, 8.0, 70000.0, num_paths, dtype)
    assert torch.equal(got, sgm_cuda.aggregate_plain(cost, 8.0, 70000.0, num_paths, dtype))
    got = _k1(emulated_k1, cost, 7.5, 30.5, num_paths, dtype)
    assert torch.equal(got, _k1(emulated_k1, cost, 7.5, 30.5, num_paths, dtype))
    want = sgm_cuda.aggregate_plain(cost, 7.5, 30.5, num_paths, dtype)
    if dtype != torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


# the largest P2 the half form takes at each path count: its 16-bit group
# sums, 3 (255 + P2) with 8 paths, and the row pairs' 16-bit stash, 255 + P2
_BOUND = {8: 21590, 4: 65280, 2: 65280}


@pytest.mark.parametrize("dtype", **_HALF)
@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_emulated_k1_half_at_its_bound(emulated_k1, num_paths, dtype):
    """``groups_fit_32_bits`` on both sides of the half form's bound, and
    the kernel there, through the wrapper: at the bound the packed launches
    (costs up to 255, and a volume whose group sums pass 2^15 with 8
    paths, the top bit of their 16-bit fields: its path values grow by 255
    a step towards 255 + P2; its fp16 totals overflow to inf, as the plain
    version's), one past it the ordered launches; bit-equal to the plain
    version on both sides."""
    bound = _BOUND[num_paths]
    assert sgm_cuda.groups_fit_32_bits(8.0, float(bound), num_paths)
    assert not sgm_cuda.groups_fit_32_bits(8.0, bound + 1.0, num_paths)
    assert not sgm_cuda.groups_fit_32_bits(8.5, 32.0, num_paths)
    assert not sgm_cuda.groups_fit_32_bits(-1.0, 32.0, num_paths)
    rng = np.random.default_rng(60 + num_paths)
    random = torch.from_numpy(rng.integers(0, 256, size=(6, 9, 16)).astype(np.uint8))
    # P1 = P2: each carry past d = 0 grows by 255 a step up to 255 + P2
    full = torch.full((88, 88, 8) if num_paths == 8 else (24, 24, 8), 255, dtype=torch.uint8)
    full[..., 0] = 0
    for p1, p2, launches, volumes in (
            (8.0, bound, _half_launches(num_paths), (random,)),
            (float(bound), bound, _half_launches(num_paths), (random, full)),
            (8.0, bound + 1, num_paths + (2 if num_paths == 2 else 4), (random,))):
        for cost in volumes:
            sgm_cuda.reset_launch_counts()
            got = _k1(emulated_k1, cost, p1, float(p2), num_paths, dtype)
            assert sgm_cuda.launch_counts["sgm_path_half"] == launches
            want = sgm_cuda.aggregate_plain(cost, p1, float(p2), num_paths, dtype)
            assert torch.equal(got, want), (p1, p2, tuple(cost.shape))
    if num_paths == 8:   # the fields' largest values, and rounding in both formats
        g2 = sum(sgm_cuda._scan_path(full.float(), float(bound), float(bound), False, shift)
                 for shift in (0, 1, -1))
        assert 2 ** 15 < float(g2.max()) < 2 ** 16
        exact = sgm_cuda.aggregate_plain(full, float(bound), float(bound), 8)
        half = sgm_cuda.aggregate_plain(full, float(bound), float(bound), 8, dtype)
        assert not torch.equal(half.float(), exact)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx, tmp = _emu_dir(tmp_path_factory)
    source, launches = _LAUNCH.subn(r"emu_launch(\1,\2,\3, ",
                                    (CSRC / "sgm_scan_pair.cu").read_text())
    assert launches == 2, launches
    (tmp / "sgm_scan_pair.cu").write_text(source)
    shutil.copy(CSRC / "sgm_scan_pair_bf16.cu", tmp)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-x", "c++",
         "-I", str(tmp), "-I", str(ROOT / "tests" / "cuda_emu"), "-o", str(tmp / "libk3.so"),
         str(tmp / "sgm_scan_pair.cu"), str(tmp / "sgm_scan_pair_bf16.cu")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(tmp / "libk3.so"))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("o3r_scan_fwd", "o3r_scan_bwd"):
        getattr(lib, name).argtypes = [ptr, ptr, i32, i32, i32, i32, f32, f32, ptr]
    lib.o3r_scan_pair.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, f32, f32, ptr]
    return lib


def _hold_against_plain(lib, cost, p1=8.0, p2=32.0):
    s, l, d = cost.shape
    code = _DTYPES[cost.dtype]
    two_pass = torch.full_like(cost, 77.0)
    assert lib.o3r_scan_fwd(cost.data_ptr(), two_pass.data_ptr(), s, l, d, code, p1, p2, None) == 0
    assert torch.equal(two_pass, sgm_cuda.scan_fwd_plain(cost, p1, p2))
    want = sgm_cuda.scan_pair_plain(cost, p1, p2)
    assert lib.o3r_scan_bwd(cost.data_ptr(), two_pass.data_ptr(), s, l, d, code, p1, p2, None) == 0
    assert torch.equal(two_pass, want)
    pair = torch.full_like(cost, 55.0)
    stash = torch.full(cost.shape, 33.0, dtype=torch.float32)
    assert lib.o3r_scan_pair(cost.data_ptr(), pair.data_ptr(), stash.data_ptr(), s, l, d, code,
                             p1, p2, None) == 0
    assert torch.equal(pair, want)


# (S, L, D): the lane splits 2, 4, 8, 16, 32 x 4 and 32 x 8; D not a multiple
# of 4 (element by element); S long enough for the steady loop (two turns of
# a ring of 16, 8 or 4 steps) and too short for it; S = 1, 2 and odd
_SHAPES = [(70, 3, 64), (45, 5, 40), (67, 3, 100), (40, 1, 200), (50, 7, 8), (37, 3, 13),
           (36, 2, 16), (19, 3, 24), (1, 3, 8), (2, 3, 64), (3, 5, 16), (9, 4, 40),
           (5, 3, 7), (6, 2, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _SHAPES)
def test_emulated_kernels_equal_plain_bits(emulated, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    cost = torch.from_numpy(rng.integers(0, 33, size=shape).astype(np.float32)).to(dtype)
    _hold_against_plain(emulated, cost)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_kernels_on_a_skewed_volume(emulated, dtype):
    """1e9 padding cells: real carries reach 1e9 there, which the slots past
    D (they hold 1e9 too) must not turn into a wrong minimum."""
    rng = np.random.default_rng(5)
    cost = torch.from_numpy(rng.integers(0, 33, size=(21, 9, 40)).astype(np.float32))
    _hold_against_plain(emulated, sgm._skew(cost, 1).to(dtype).contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_kernels_on_a_misaligned_buffer(emulated, dtype):
    """A volume that does not start on 16 bytes takes the element-by-element
    form though D is a multiple of 4."""
    rng = np.random.default_rng(6)
    shape = (20, 3, 64)
    buffer = torch.empty(int(np.prod(shape)) + 1, dtype=dtype)
    cost = buffer[1:].view(shape)
    cost.copy_(torch.from_numpy(rng.integers(0, 33, size=shape).astype(np.float32)))
    assert cost.data_ptr() % 16 != 0
    _hold_against_plain(emulated, cost)


@pytest.fixture(scope="module")
def emulated_k4(tmp_path_factory):
    gxx, tmp = _emu_dir(tmp_path_factory)
    source, launches = _ANY_LAUNCH.subn(r"emu_launch(\1,\2,\3, ",
                                        (CSRC / "census_cost.cu").read_text())
    assert launches == 1, launches
    (tmp / "census_cost.cu").write_text(source)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-x", "c++",
         "-I", str(tmp), "-I", str(ROOT / "tests" / "cuda_emu"), "-o", str(tmp / "libk4.so"),
         str(tmp / "census_cost.cu")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(tmp / "libk4.so"))
    lib.o3r_census_cost.argtypes = cuda_build.SIGNATURES["o3r_census_cost"]
    return lib


def _quantised_pair(h, w, seed):
    """A left image in steps of 1/255 with flat patches (one in the top-left
    corner, so replicated borders compare equal values too), and a right
    image that is the left shifted by 3 columns with a tenth of its pixels
    redrawn."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, size=(h, w)).astype(np.float32) / 255.0
    left[:min(h, 4), :min(w, 5)] = left[0, 0]
    left[h // 2:h // 2 + 3, w // 3:w // 3 + 7] = 128 / 255.0
    right = np.roll(left, -3, axis=1)
    redraw = rng.random((h, w)) < 0.1
    right[redraw] = rng.integers(0, 256, size=int(redraw.sum())) / 255.0
    return torch.from_numpy(left), torch.from_numpy(np.ascontiguousarray(right))


def _k4(lib, left, right, window, d, offset=0):
    """The emulated K4 into a fresh volume starting ``offset`` bytes into its
    buffer, which is filled with 0xAB first (every byte must be written)."""
    h, w = left.shape
    buffer = torch.full((h * w * d + offset,), 0xAB, dtype=torch.uint8)
    cost = buffer[offset:].view(h, w, d)
    rc = lib.o3r_census_cost(left.data_ptr(), right.data_ptr(), cost.data_ptr(), h, w, d,
                             window[0], window[1], None)
    assert rc == 0, rc
    return cost


# (H, W, D, window): one tile narrower than D (D > W) at D = 64 and 128,
# three tiles with a ragged last one (the right codes start past column 0),
# D not a multiple of 16 (the byte-by-byte pieces), D = 256 and D = 1, and
# the windows the compare loop takes at run time
_K4_CASES = [(37, 45, 64, (5, 5)), (37, 45, 128, (5, 5)), (9, 300, 64, (5, 5)),
             (9, 300, 128, (3, 3)), (11, 150, 40, (7, 3)), (6, 131, 64, (3, 11)),
             (5, 140, 256, (5, 5)), (4, 70, 1, (3, 3)), (3, 9, 24, (5, 5))]


@pytest.mark.parametrize("h, w, d, window", _K4_CASES)
def test_emulated_k4_equals_plain_bits(emulated_k4, h, w, d, window):
    left, right = _quantised_pair(h, w, h * w + d)
    assert bool((left[:, 1:] == left[:, :-1]).any())       # ties
    want = sgm_cuda.census_cost_plain(left, right, window, d)
    got = _k4(emulated_k4, left, right, window, d)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert int(want.max()) <= 32 and bool((want[:, 0, 1:] == 32).all())


@pytest.mark.parametrize("d", [64, 40])
def test_emulated_k4_on_a_misaligned_volume(emulated_k4, d):
    """A volume that starts 5 bytes past 16: the pieces aligned in memory,
    the tile's ragged ends stored byte by byte, though D = 64 divides by 16."""
    left, right = _quantised_pair(13, 150, d)
    got = _k4(emulated_k4, left, right, (5, 5), d, offset=5)
    assert got.data_ptr() % 16 != 0
    assert torch.equal(got, sgm_cuda.census_cost_plain(left, right, (5, 5), d))


def test_emulated_k4_rejects_what_it_does_not_take(emulated_k4):
    """The C entry's own checks (the wrapper raises before them): even
    windows, more than 32 bits, D outside [1, 256], an empty image."""
    left, right = _quantised_pair(4, 8, 0)
    cost = torch.zeros(4 * 8 * 300, dtype=torch.uint8)
    for h, w, d, wh, ww in ((4, 8, 16, 4, 5), (4, 8, 16, 5, 7), (4, 8, 257, 5, 5),
                            (4, 8, 0, 5, 5), (0, 8, 16, 5, 5), (4, 8, 16, 35, 1)):
        assert emulated_k4.o3r_census_cost(left.data_ptr(), right.data_ptr(), cost.data_ptr(),
                                           h, w, d, wh, ww, None) != 0
    assert not bool(cost.any())


@pytest.fixture(scope="module")
def emulated_k5(tmp_path_factory):
    gxx, tmp = _emu_dir(tmp_path_factory)
    source, launches = _ANY_LAUNCH.subn(r"emu_launch(\1,\2,\3, ",
                                        (CSRC / "voxel_reduce.cu").read_text())
    assert launches == 3, launches
    (tmp / "voxel_reduce.cu").write_text(source)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-x", "c++",
         "-I", str(tmp), "-I", str(ROOT / "tests" / "cuda_emu"), "-o", str(tmp / "libk5.so"),
         str(tmp / "voxel_reduce.cu")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(tmp / "libk5.so"))
    for name in ("o3r_voxel_keys", "o3r_voxel_heads", "o3r_voxel_reduce"):
        getattr(lib, name).argtypes = cuda_build.SIGNATURES[name]
    return lib



def _k5(lib, cloud, voxel_size, bounds, monkeypatch):
    """The emulated K5 through the wrapper's own launch sequence, every
    tensor it allocates first filled with 0xAB bytes (each output slot must
    be written)."""
    empty = torch.empty

    def filled(*args, dtype, **kwargs):
        return empty(*args, dtype=dtype, **kwargs).view(torch.uint8).fill_(0xAB).view(dtype)

    before = voxel.launch_counts["voxel_reduce"]
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", filled)
        out = voxel.k5_launches(lib, lambda entry, *args: entry(*args, None), cloud,
                                voxel_size, bounds)
    assert voxel.launch_counts["voxel_reduce"] == before + 1
    return out


def _pool(n, runs, seed, voxel_size=0.25, invalid=0.2, outside=0, extra=None):
    """A shuffled pool of ``n`` slots: ``runs`` = (count, length) pairs, each
    a voxel of the grid of bounds 8 holding that many points, then
    ``outside`` valid points out of that grid, ``extra`` points, and the
    rest invalid; ``invalid`` is the share of the others made invalid too."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(40**3, size=sum(c for c, _ in runs), replace=False)
    corners = (np.stack(np.unravel_index(cells, (40, 40, 40)), 1) - 20) * voxel_size
    lengths = np.repeat([l for _, l in runs], [c for c, _ in runs])
    pts = [np.repeat(corners, lengths, 0) + rng.random((lengths.sum(), 3)) * voxel_size,
           rng.choice([-1.0, 1.0], size=(outside, 3)) * 9.0]
    if extra is not None:
        pts.append(extra)
    pts = np.concatenate(pts).astype(np.float32)
    used = len(pts)
    assert used <= n
    pts = np.concatenate([pts, rng.normal(size=(n - used, 3)).astype(np.float32)])
    cols = rng.random((n, 3)).astype(np.float32)
    valid = (np.arange(n) < used) & (rng.random(n) >= invalid)
    perm = rng.permutation(n)
    return PointCloud(torch.from_numpy(pts[perm]), torch.from_numpy(cols[perm]),
                      torch.from_numpy(valid[perm]))


def _assert_bits(got, want):
    assert torch.equal(got.valid.view(torch.uint8), want.valid.view(torch.uint8))
    assert torch.equal(got.points.view(torch.int32), want.points.view(torch.int32))
    assert torch.equal(got.colors.view(torch.int32), want.colors.view(torch.int32))


# (n, runs, invalid share, valid points outside the grid): a pool mostly
# invalid; runs of 1, ~30 and > 256 (one thread walks 300, another 700
# points); points out of bounds; all invalid; a length no multiple of the
# block (256 threads)
_K5_CASES = {
    "mostly_invalid": (4096, [(40, 3)], 0.1, 0),
    "run_lengths": (3000, [(200, 1), (30, 31), (1, 300), (1, 700)], 0.05, 0),
    "out_of_bounds": (2048, [(100, 4)], 0.0, 300),
    "all_invalid": (1024, [(50, 5)], 1.0, 0),
    "ragged_length": (2531, [(90, 7), (500, 2)], 0.3, 17),
}


@pytest.mark.parametrize("case", list(_K5_CASES))
def test_emulated_k5_equals_plain_bits(emulated_k5, case, monkeypatch):
    n, runs, invalid, outside = _K5_CASES[case]
    cloud = _pool(n, runs, len(case), invalid=invalid, outside=outside)
    want = voxel.voxel_downsample_plain(cloud, 0.25, 8.0)
    got = _k5(emulated_k5, cloud, 0.25, 8.0, monkeypatch)
    _assert_bits(got, want)
    voxels = int(want.valid.sum())
    assert bool(want.valid[:voxels].all())
    assert voxels == 0 if invalid == 1.0 else voxels > 30


def _card_keys(cloud, voxel_size, bounds):
    """``voxel.voxel_keys`` with PyTorch's CUDA arithmetic, written out: the
    card multiplies by the float32 reciprocal where the CPU divides."""
    per = int(2.0 * bounds / voxel_size) + 2
    inv = torch.tensor(np.float32(1.0) / np.float32(voxel_size))
    idx = torch.floor((cloud.points + bounds) * inv).to(torch.int64)
    inside = ((idx >= 0) & (idx < per)).all(dim=1) & cloud.valid
    return torch.where(inside, (idx[:, 0] * per + idx[:, 1]) * per + idx[:, 2],
                       voxel._SENTINEL)


def test_emulated_k5_keys_as_the_card_computes_them(emulated_k5, monkeypatch):
    """At EuRoC's grid (2.5 cm, bounds 204.8 m) 1 / voxel_size is inexact:
    the pool holds 60 points (and any of its others) whose voxel differs
    between the CPU's division and the card's reciprocal. K5 keys them as
    the card does, and given those keys its centroids are the plain
    reduction's bits."""
    size, bounds = 0.025, 204.8
    rng = np.random.default_rng(21)
    cand = rng.uniform(-0.4, 0.4, size=(400_000, 3)).astype(np.float32)
    x = cand + np.float32(bounds)
    split = (np.floor(x / np.float32(size))
             != np.floor(x * (np.float32(1.0) / np.float32(size)))).any(1)
    cloud = _pool(3000, [(40, 30)], 7, voxel_size=size, invalid=0.0,
                  extra=cand[split][:60])
    card = _card_keys(cloud, size, bounds)
    assert int((card != voxel.voxel_keys(cloud, size, bounds)).sum()) >= 60
    got = _k5(emulated_k5, cloud, size, bounds, monkeypatch)
    _assert_bits(got, voxel.segment_centroids_plain(cloud, card))
    assert not torch.equal(got.points, voxel.voxel_downsample_plain(cloud, size, bounds).points)


def test_k5_rejects_what_it_does_not_take(emulated_k5):
    """The wrapper raises, on either device, for a dtype, shape, contiguity
    or device K5 does not take; the C entries refuse lengths and grids."""
    good = _pool(512, [(10, 3)], 0)
    bad = [good._replace(points=good.points.double()),
           good._replace(colors=good.colors.half()),
           good._replace(valid=good.valid.to(torch.uint8)),
           good._replace(points=good.points[:, :2].contiguous()),
           good._replace(valid=good.valid[:-1]),
           good._replace(points=good.points.t().contiguous().t()),
           good._replace(colors=torch.cat([good.colors, good.colors], 1)[:, :3]),
           good._replace(valid=good.valid.to("meta")),
           PointCloud(*(t.to("meta") for t in good))]
    for cloud in bad:
        with pytest.raises(ValueError):
            voxel.voxel_downsample(cloud, 0.25, 8.0)
    with pytest.raises(ValueError, match="too fine"):
        voxel.voxel_downsample(good, 1e-4, 8.0)
    key = torch.zeros(512, dtype=torch.int64)
    lib = emulated_k5
    for n, per_axis in ((-1, 66), (2**31, 66), (512, 0), (512, 2**21 + 1)):
        assert lib.o3r_voxel_keys(good.points.data_ptr(), good.valid.data_ptr(),
                                  key.data_ptr(), n, 8.0, 4.0, per_axis, None) != 0
    assert lib.o3r_voxel_heads(key.data_ptr(), key.data_ptr(), -1, None) != 0
    assert lib.o3r_voxel_reduce(*[key.data_ptr()] * 8, 2**31, None) != 0
    assert not bool(key.any())
