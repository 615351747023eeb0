"""Stage timing and per-kernel roofline accounting (port of
utils/roofline.py).

``measure`` / ``measure_amortized``: on a CUDA device a time is device time
between CUDA events recorded around the calls, after a warm-up call; on the
CPU it is the host clock. The device is the one the arguments' tensors lie
on.

``RooflinePoint`` pairs an analytic work model (bytes moved, operations)
with a measured runtime and reports achieved against peak bandwidth and
compute, and which roof binds. ``H100_PEAKS`` holds the published peaks of
one NVIDIA H100 SXM (data sheet, dense rates, at the full 700 W power
limit): HBM3 3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
f32 on the CUDA cores (outside the tensor cores). A card set below 700 W
runs slower: state its power limit beside a share of these roofs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch


H100_PEAKS = {
    "hbm_gbps": 3350.0,
    "tensor_tflops_bf16": 989.0,
    "cuda_core_tops_f32": 67.0,
}


@dataclass
class RooflinePoint:
    name: str
    bytes_accessed: float
    flops: float                  # matmul FLOPs (tensor-core eligible)
    vector_ops: float             # elementwise / min operations (CUDA cores)
    seconds: float
    notes: str = ""

    @property
    def arithmetic_intensity(self) -> float:
        return (self.flops + self.vector_ops) / max(self.bytes_accessed, 1.0)

    def report(self, peaks: Optional[Dict[str, float]] = None) -> Dict:
        peaks = peaks or H100_PEAKS
        if not np.isfinite(self.seconds) or self.seconds <= 0:
            # no resolvable time: publish the fact, never a made-up number
            return {"kernel": self.name, "invalid":
                    "kernel too fast to resolve above dispatch noise",
                    "notes": self.notes}
        bw = self.bytes_accessed / self.seconds / 1e9
        tensor = self.flops / self.seconds / 1e12
        cuda_core = self.vector_ops / self.seconds / 1e12
        bw_frac = bw / peaks["hbm_gbps"]
        tensor_frac = tensor / peaks["tensor_tflops_bf16"]
        cuda_core_frac = cuda_core / peaks["cuda_core_tops_f32"]
        bound = max(("hbm", bw_frac), ("tensor", tensor_frac),
                    ("cuda_core", cuda_core_frac), key=lambda kv: kv[1])
        if bound[1] > 1.0:
            # >100% of a hardware roof is by definition a measurement failure
            return {"kernel": self.name, "invalid":
                    f"measured {100.0 * bound[1]:.0f}% of {bound[0]} peak — "
                    "impossible; timing below the resolvable floor",
                    "time_ms": self.seconds * 1e3, "notes": self.notes}
        return {
            "kernel": self.name,
            "time_ms": self.seconds * 1e3,
            "bytes": self.bytes_accessed,
            "achieved_gbps": bw,
            "achieved_tensor_tflops": tensor,
            "achieved_cuda_core_tops": cuda_core,
            "pct_hbm_peak": 100.0 * bw_frac,
            "pct_tensor_peak": 100.0 * tensor_frac,
            "pct_cuda_core_peak": 100.0 * cuda_core_frac,
            "binding_roof": bound[0],
            "pct_of_binding_roof": 100.0 * bound[1],
            "arithmetic_intensity": self.arithmetic_intensity,
            "notes": self.notes,
        }


def _device(args) -> Optional[torch.device]:
    """The device of the first tensor in ``args``, nested tuples and lists
    included (None if there is none)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (tuple, list)):
            dev = _device(a)
            if dev is not None:
                return dev
    return None


def _seconds(fn: Callable, args, count: int, dev: Optional[torch.device]) -> float:
    """Seconds for ``count`` back-to-back calls, ended by the device."""
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(count):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    for _ in range(count):
        fn(*args)
    return time.perf_counter() - t0


def measure(fn: Callable, args, n: int = 5,
            reset: Optional[Callable[[], None]] = None) -> float:
    """Median seconds of one ``fn(*args)`` call over ``n`` calls, each
    timed alone, after one warm-up call. ``reset()``, if given, runs before
    every call, outside the timed window: it puts back the state a call
    changes (a pool it fills, a window it slides)."""
    dev = _device(args)
    times = []
    for i in range(n + 1):
        if reset is not None:
            reset()
        if i == 0:
            fn(*args)
        else:
            times.append(_seconds(fn, args, 1, dev))
    return float(np.median(times))


def measure_amortized(fn: Callable, args, inner: int = 8, n: int = 3) -> float:
    """Seconds per ``fn(*args)`` call over ``inner`` back-to-back calls (the
    median of ``n`` such runs, after one warm-up call): on a CUDA device the
    launches queue ahead, so the host's launch cost hides behind the device
    work wherever the device is the slower of the two."""
    dev = _device(args)
    fn(*args)
    return float(np.median([_seconds(fn, args, inner, dev) / inner
                            for _ in range(n)]))


# --------------------------------------------------------------------------
# Analytic work models (the reference's arithmetic)
# --------------------------------------------------------------------------

def sgm_aggregation_model(h: int, w: int, d: int, num_paths: int,
                          seconds: float, itemsize: int = 2) -> RooflinePoint:
    """SGM path aggregation (K1, ``stereo.sgm_cuda.aggregate``).

    Memory is the PROBLEM's lower bound: read the cost volume once, write
    the aggregation once (2 passes x ``itemsize``), so the share of the
    binding roof measures the distance to the speed of light, not to the
    kernel's own traffic. Compute: per cell and direction ~10 elementwise
    operations (2 shifted adds, 5 mins, 1 sub, 1 add, the carry) plus the
    D-wide min reduction at ~1 operation a cell.
    """
    cells = h * w * d
    return RooflinePoint(
        name=f"sgm_aggregation_{num_paths}path_{h}x{w}x{d}",
        bytes_accessed=2 * cells * itemsize, flops=0.0,
        vector_ops=num_paths * cells * 11, seconds=seconds,
        notes="all directions in one launch; bytes = problem lower bound")


def matching_model(ka: int, kb: int, bits: int, seconds: float) -> RooflinePoint:
    """Descriptor matching as a bipolar matmul (features/match.py)."""
    return RooflinePoint(
        name=f"hamming_matmul_{ka}x{kb}x{bits}",
        bytes_accessed=(ka * bits + kb * bits) * 2 + ka * kb * 4,
        flops=2.0 * ka * kb * bits, vector_ops=ka * kb * 4,
        seconds=seconds, notes="matmul + top-k")


def ba_schur_model(w_kf: int, l_lm: int, n_obs: int, gn_iters: int,
                   seconds: float) -> RooflinePoint:
    """Dense-block Schur GN solve (ba/schur.py)."""
    per_iter_flops = (
        n_obs * (2 * 18 * 6 + 2 * 9 * 3 + 2 * 18 * 3 + 18 + 9)  # JtJ blocks
        + l_lm * 40                                # 3x3 inverses
        + w_kf * l_lm * (2 * 18 * 3 + 2 * 18 * 6 * w_kf / max(w_kf, 1))
        + w_kf * l_lm * 6 * 3 * 6 * w_kf * 2       # S coupling product
        + (6 * w_kf) ** 3 / 3                      # Cholesky
    )
    bytes_accessed = gn_iters * (
        n_obs * (4 * 3 * 3 + 4 * 2) + w_kf * l_lm * 18 * 4 * 3 + l_lm * 9 * 4 * 2)
    return RooflinePoint(
        name=f"ba_schur_w{w_kf}_l{l_lm}_n{n_obs}_it{gn_iters}",
        bytes_accessed=bytes_accessed, flops=gn_iters * per_iter_flops,
        vector_ops=0.0, seconds=seconds,
        notes="dense-block Schur: block assembly + Cholesky")


def voxel_model(n_points: int, seconds: float) -> RooflinePoint:
    """Sort + segment-reduce voxel filter (mapping/voxel.py)."""
    log_n = max(1.0, np.log2(max(n_points, 2)))
    return RooflinePoint(
        name=f"voxel_downsample_{n_points}",
        bytes_accessed=n_points * 4 * (2 * log_n * 0.5 + 10), flops=0.0,
        vector_ops=n_points * log_n * 4, seconds=seconds,
        notes="the stable sort dominates")
