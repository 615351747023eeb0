"""Stage timing for the profilers (port of utils/roofline.py's ``measure``
and ``measure_amortized``).

On a CUDA device a time is device time between CUDA events recorded around
the calls, after a warm-up call; on the CPU it is the host clock. The
device is the one the arguments' tensors lie on. The reference's TPU peaks
table and roofline models are not ported.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch


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


def measure(fn: Callable, args, n: int = 5) -> float:
    """Median seconds of one ``fn(*args)`` call over ``n`` calls, each
    timed alone, after one warm-up call."""
    dev = _device(args)
    fn(*args)
    return float(np.median([_seconds(fn, args, 1, dev) for _ in range(n)]))


def measure_amortized(fn: Callable, args, inner: int = 8, n: int = 3) -> float:
    """Seconds per ``fn(*args)`` call over ``inner`` back-to-back calls (the
    median of ``n`` such runs, after one warm-up call): on a CUDA device the
    launches queue ahead, so the host's launch cost hides behind the device
    work wherever the device is the slower of the two."""
    dev = _device(args)
    fn(*args)
    return float(np.median([_seconds(fn, args, inner, dev) / inner
                            for _ in range(n)]))
