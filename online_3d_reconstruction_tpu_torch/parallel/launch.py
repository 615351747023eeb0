"""Start the ranks of a multi-rank job as fresh processes on this machine's
CPU and collect what each returns.

``torch.distributed`` is one process per rank; where the reference builds a
mesh of N devices inside one process, the port needs N processes. On cards,
``torchrun`` starts them (see runtime/distributed.py). This helper is the
CPU form the tests and ``tools.scaling_bench`` use: ``run_ranks`` starts
``world_size`` Python processes over ``gloo`` with a file store in
``workdir``, each calls ``module:function(mesh, workdir)`` and writes the
dict of arrays it returns to ``workdir/rank<r>.npz``; the parent returns the
dicts in rank order. Every wait has a limit: a hung rank fails the call, it
does not hang the caller.

    python -m online_3d_reconstruction_tpu_torch.parallel.launch \\
        --target pkg.module:function --rank 0 --world 4 --workdir /tmp/job
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

_PKG_PARENT = str(Path(__file__).resolve().parents[2])


def run_ranks(target: str, world_size: int, workdir: "str | os.PathLike",
              timeout: float = 120.0) -> List[Dict[str, np.ndarray]]:
    """Run ``target`` ("package.module:function") on ``world_size`` CPU ranks
    and return each rank's result. Raises ``RuntimeError`` with the rank's
    stderr if one fails, ``TimeoutError`` (after killing all) if they are
    not done within ``timeout`` seconds."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        store.unlink()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_PARENT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    for rank in range(world_size):
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--target", target, "--rank", str(rank),
             "--world", str(world_size), "--workdir", str(workdir),
             "--timeout", str(timeout)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    deadline = time.monotonic() + timeout
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"rank {rank} of {target} not done in {timeout} s") from None
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            tail = (workdir / f"rank{rank}.log").read_text()[-4000:]
            raise RuntimeError(f"rank {rank} of {target} exited {proc.returncode}:\n{tail}")
    results = []
    for rank in range(world_size):
        with np.load(workdir / f"rank{rank}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


def _rank_main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--target", required=True, help="package.module:function")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--timeout", type=float, default=120.0)
    args = p.parse_args(argv)

    import torch

    from online_3d_reconstruction_tpu_torch.parallel.mesh import make_mesh
    from online_3d_reconstruction_tpu_torch.runtime.distributed import initialize

    # the ranks share this machine's cores with each other and with the caller
    torch.set_num_threads(1)
    initialize(f"file://{Path(args.workdir) / 'store'}", args.world, args.rank,
               backend="gloo", timeout_s=args.timeout)
    try:
        module, function = args.target.split(":")
        result = getattr(importlib.import_module(module), function)(
            make_mesh(device="cpu"), args.workdir)
        np.savez(Path(args.workdir) / f"rank{args.rank}.npz", **(result or {}))
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(_rank_main())
