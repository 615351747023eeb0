"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, one run of the cell at its own size with a short window,
then the check twice, against the plain reference at the configuration's
storage (the sound reading) and against the same reference with SGM stored
in fp8 (the control). One JSON line a seed; the benchmark's own runs never
run this.

    python3 -m o3r_bench.control --workload <cell> --seconds 6 --seeds 1 2 3 ...
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from o3r_bench.run import load_cell  # noqa: E402  (sets the cache directories)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=6.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from o3r_bench.harness import run_cell

    _, cell, doc, mix = load_cell(args.workload)
    for seed in args.seeds:
        out = run_cell(doc, mix, seed, args.seconds, False, "cuda",
                       t_start=time.perf_counter(), controls=True)
        print(json.dumps({"workload": cell["name"], "seed": seed, "frames": out["frames"],
                          "sound": out["numbers"], "control": out["control_numbers"],
                          "limits": out["limits"], "correct": out["correct"],
                          "check_s": out["check_s"], "setup_s": out["setup_s"],
                          "events": out["plan"].events, "sampled_frames": out["plan"].frames}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
