"""The parts of descriptor matching, timed one by one (port of
tools/profile_match.py).

    python -m online_3d_reconstruction_tpu_torch.tools.profile_match [--device cuda]

512 x 512 descriptors of 256 bits: the bit unpack, the bipolar matrix
product, the assembled Hamming matrix, the top-2 search, the cross-check
argmin and the whole ``match_descriptors``, to see whether matching's
distance to its roof is the product or the fixed cost of the small
operations around it. Each row is ``utils.roofline.measure_amortized`` (on a
card: CUDA events over back-to-back calls); on a card it stands beside the
share of the binding H100 roof that ``utils.roofline.matching_model`` gives
the whole matching problem at that time. The product is a plain
``torch.matmul`` in f32 (TF32 off).
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from online_3d_reconstruction_tpu_torch.features.match import (
    _unpack_bipolar,
    hamming_matrix,
    match_descriptors,
)
from online_3d_reconstruction_tpu_torch.runtime.pipeline import resolve_device
from online_3d_reconstruction_tpu_torch.utils.roofline import matching_model, measure_amortized


def main(argv=None) -> List[Tuple[str, float]]:
    """Prints one row per part and returns [(name, seconds), ...]."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          flush=True)
    ka = kb = 512
    rng = np.random.default_rng(0)

    def descriptors(k):
        words = rng.integers(0, 2**32, (k, 8), dtype=np.uint32)
        return torch.from_numpy(words.astype(np.int64)).to(dev)

    desc_a, desc_b = descriptors(ka), descriptors(kb)
    va = torch.ones(ka, dtype=torch.bool, device=dev)
    rows: List[Tuple[str, float]] = []

    def report(name, sec):
        rows.append((name, sec))
        line = f"{name:44s} {sec * 1e6:9.1f} us"
        if dev.type == "cuda":
            roof = matching_model(ka, kb, 256, sec).report()
            line += (f"  {roof['pct_of_binding_roof']:.3f}% of the {roof['binding_roof']} roof"
                     if "invalid" not in roof else f"  ({roof['invalid']})")
        print(line, flush=True)

    report("unpack bipolar (512x256)",
           measure_amortized(_unpack_bipolar, (desc_a,), inner=64))
    a, b = _unpack_bipolar(desc_a), _unpack_bipolar(desc_b)
    report("bipolar matmul 512x512x256 (f32 in)",
           measure_amortized(lambda x: x @ b.t(), (a,), inner=64))
    report("hamming_matrix (unpack+mm+mask)",
           measure_amortized(lambda d: hamming_matrix(d, desc_b, va, va), (desc_a,),
                             inner=64))
    dist = hamming_matrix(desc_a, desc_b, va, va)
    report("top_k(2) over 512x512",
           measure_amortized(lambda d: torch.topk(-d, 2), (dist,), inner=64))
    report("argmin axis=0 (cross-check)",
           measure_amortized(lambda d: torch.argmin(d, dim=0), (dist,), inner=64))
    report("FULL match_descriptors",
           measure_amortized(lambda d: match_descriptors(d, desc_b, va, va), (desc_a,),
                             inner=64))
    return rows


if __name__ == "__main__":
    main()
