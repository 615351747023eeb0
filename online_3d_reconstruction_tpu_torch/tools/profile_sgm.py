"""Where the per-pair (v2) SGM aggregation spends its time (port of
tools/profile_sgm.py): the scan pairs K3 runs, the shears around a diagonal,
and K1's all-directions aggregation beside them.

    python -m online_3d_reconstruction_tpu_torch.tools.profile_sgm
        [--device cuda] [--size 384 512 64]

Per storage dtype (float32, bfloat16): the vertical pair (``scan_pair``
along H), its two passes alone (``scan_launch``), the
horizontal pair (transpose + scan + transpose), one diagonal (``_skew`` +
``scan_pair`` + ``_deskew``: an (H, W + H - 1, D) volume with 1e9 in its
padding cells) and the skew alone; then K1's 8- and 4-path ``aggregate`` on
the uint8 cost. Each row is ``utils.roofline.measure_amortized``: on a CUDA
card device time between CUDA events, on the CPU the host clock (and the
kernels' plain versions). A scan row also prints effective GB/s: the pair's
compulsory bytes (its cost volume read once, its total written once) over
its time.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
from online_3d_reconstruction_tpu_torch.stereo.sgm import _deskew, _skew
from online_3d_reconstruction_tpu_torch.stereo.sgm_cuda import (
    aggregate,
    scan_launch,
    scan_pair,
)
from online_3d_reconstruction_tpu_torch.utils.roofline import measure_amortized

P1, P2 = 8.0, 32.0
DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16))
SCAN_ROWS = ("vertical scan_pair", "horizontal (swap+scan+swap)",
             "diagonal (skew+scan+deskew)", "skew alone")
PASS_ROWS = ("vertical forward pass alone", "vertical backward pass alone")
K1_ROWS = ("FULL aggregate 8-path", "FULL aggregate 4-path")


def main(height: int = 384, width: int = 512, disparity: int = 64,
         device: "torch.device | str" = "cuda") -> List[Tuple[str, float]]:
    """Time every row at (height, width, disparity) on ``device``, print one
    line per row, and return [(name, ms), ...]."""
    dev = resolve_device(device)
    h, w, d = height, width, disparity
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    rng = np.random.default_rng(0)
    cost_f32 = torch.from_numpy(rng.integers(0, 24, (h, w, d)).astype(np.float32)).to(dev)
    rows: List[Tuple[str, float]] = []

    def bench(label, fn, args, pair_bytes=0):
        sec = measure_amortized(fn, args, inner=8)
        rows.append((label, sec * 1e3))
        rate = f" ({pair_bytes / sec / 1e9:.1f} GB/s eff)" if pair_bytes else ""
        print(f"{label:40s} {sec * 1e3:8.3f} ms{rate}", flush=True)

    for tag, dtype in DTYPES:
        cost = cost_f32.to(dtype)
        volume = 2 * cost.numel() * cost.element_size()    # cost in, total out
        skew_volume = volume * (w + h - 1) // w
        vertical, horizontal, diagonal, skew = (f"[{tag}] {r}" for r in SCAN_ROWS)
        bench(vertical, lambda c: scan_pair(c, P1, P2), (cost,), volume)
        out = torch.empty_like(cost)
        for label, one_pass in zip(PASS_ROWS, ("scan_fwd", "scan_bwd")):
            bench(f"[{tag}] {label}",
                  lambda c, k=one_pass: scan_launch(k, c, out, P1, P2), (cost,))
        bench(horizontal,
              lambda c: scan_pair(c.transpose(0, 1).contiguous(), P1, P2).transpose(0, 1)
              .contiguous(), (cost,), volume)
        bench(diagonal,
              lambda c: _deskew(scan_pair(_skew(c, 1).contiguous(), P1, P2)
                                .to(torch.float32), 1, w).contiguous(),
              (cost,), skew_volume)
        bench(skew, lambda c: _skew(c, 1).contiguous(), (cost,))

    cost_u8 = cost_f32.to(torch.uint8)     # what K1 reads (census costs are <= 32)
    for label, paths in zip(K1_ROWS, (8, 4)):
        bench(label, lambda c, n=paths: aggregate(c, P1, P2, n), (cost_u8,))
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, nargs=3, default=(384, 512, 64),
                        metavar=("HEIGHT", "WIDTH", "DISPARITY"))
    args = parser.parse_args()
    main(*args.size, device=args.device)
