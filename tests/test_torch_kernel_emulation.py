"""K1's and K3's CUDA sources themselves, run on the CPU:
``tests/cuda_emu/cuda_emu.h`` stands in for the CUDA runtime (one OS thread
per CUDA thread, barriers for the warp shuffles, real atomics for the
reductions), g++ builds ``csrc/sgm_aggregate.cu`` and ``csrc/sgm_scan_pair.cu``
(with its bfloat16 unit) against it, and ctypes calls the same entry points
the port binds.

K1: both storage forms, through the wrapper's own launch sequence
(``sgm_cuda.k1_launches``), at 2, 4 and 8 paths, every lane split, with
integer penalties (the packed launches), integer ones too large to pack and
fractional ones (the ordered launches), on costs whose sums cross 256, so
that bf16 rounds: bit-equal to ``aggregate_plain`` except the f32 form with
fractional penalties, which adds the directions in another order (within
f32 rounding). K3: each pass alone and the one-launch pair bit-equal to the
plain versions, at every lane split (D from 1 to 200), in the vector and the
element-by-element form, through the branch-free steady loop and the last
turns, at S = 1, 2 and odd S, with fewer lines than a warp's chains, and on
a skewed volume with 1e9 padding cells. What only the card can show (that
nvcc builds them, their times) stays with ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

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
    for header in ("cuda_runtime.h", "cuda_bf16.h"):
        (tmp / header).write_text('#include "cuda_emu.h"\n')
    return gxx, tmp


@pytest.fixture(scope="module")
def emulated_k1(tmp_path_factory):
    gxx, tmp = _emu_dir(tmp_path_factory)
    source, launches = _ANY_LAUNCH.subn(r"emu_launch(\1,\2,\3, ",
                                        (CSRC / "sgm_aggregate.cu").read_text())
    assert launches == 6, launches
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
# disparities a line, and 32 lanes of 8; lines longer than the prefetch ring
_K1_SHAPES = [(9, 13, 8), (10, 7, 16), (6, 11, 32), (5, 9, 64), (4, 6, 128), (3, 5, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_emulated_k1_equals_plain_bits(emulated_k1, num_paths, dtype):
    """Integer penalties: the packed launches (all directions in one, then
    the widening or the four roundings) give ``aggregate_plain``'s bits at
    every lane split; costs up to 160 make the sums cross 256."""
    for shape in _K1_SHAPES:
        rng = np.random.default_rng(sum(shape) + num_paths)
        cost = torch.from_numpy(rng.integers(0, 161, size=shape).astype(np.uint8))
        assert sgm_cuda.sums_fit_16_bits(8.0, 32.0, num_paths)
        got = _k1(emulated_k1, cost, 8.0, 32.0, num_paths, dtype)
        want = sgm_cuda.aggregate_plain(cost, 8.0, 32.0, num_paths, dtype)
        assert got.dtype == dtype and torch.equal(got, want), shape
    if dtype == torch.bfloat16 and num_paths == 8:
        assert not torch.equal(want.float(), sgm_cuda.aggregate_plain(cost, 8.0, 32.0, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_emulated_k1_ordered_launches(emulated_k1, num_paths, dtype):
    """Penalties the packed launches do not take, launched direction by
    direction: integer ones too large to pack give the plain bits in both
    forms; fractional ones the plain bits in bf16 (the TPU kernel's order of
    additions and its roundings) and within f32 rounding in f32 (1e-6
    relative: the plain version adds the directions in pairs), the same in
    two runs."""
    rng = np.random.default_rng(40 + num_paths)
    cost = torch.from_numpy(rng.integers(0, 161, size=(7, 10, 16)).astype(np.uint8))
    assert not sgm_cuda.sums_fit_16_bits(8.0, 40000.0, num_paths)
    got = _k1(emulated_k1, cost, 8.0, 40000.0, num_paths, dtype)
    assert torch.equal(got, sgm_cuda.aggregate_plain(cost, 8.0, 40000.0, num_paths, dtype))
    got = _k1(emulated_k1, cost, 7.5, 30.5, num_paths, dtype)
    assert torch.equal(got, _k1(emulated_k1, cost, 7.5, 30.5, num_paths, dtype))
    want = sgm_cuda.aggregate_plain(cost, 7.5, 30.5, num_paths, dtype)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


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
