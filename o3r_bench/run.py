"""The benchmark of the PyTorch/CUDA port, one cell a run:

    python3 -m o3r_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration file and a traffic mix (``traffic/<name>.json``);
each per-layer metric is read by ``metrics/<name>.py``. The run makes its
inputs on the card from the seed, warms up, measures for ``--seconds``
(``harness``), checks what the timed path produced against the plain
reference (``check``), and prints one JSON line as the last line of its
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``, then ``checks``: each number
compared with its limit, which are also the last lines of standard error.
Without a card, or with fewer than the cell asks for, it prints no result
and exits 2; with JAX or the JAX package loaded once the window has
closed, it exits 4.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the build and kernel caches stay inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / "build" / _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "online_3d_reconstruction_tpu")
TIME_LIMIT_S = 350


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_START


def load_cell(name: str, root: Path = ROOT):
    """(benchmark, cell, configuration document, traffic mix) of a cell of
    ``root``'s ``BENCHMARK.json``: the configuration from its ``file``, the
    mix from ``o3r_bench/traffic/<traffic>.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    doc = json.loads((root / config["file"]).read_text())
    mix = json.loads((root / HERE.name / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, doc, mix


def metrics_of(bench: dict, cell: str, kind: str):
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer")."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(name: str, root: Path = ROOT):
    """The per-layer metric's reader module, ``o3r_bench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"o3r_bench_metric_{name}", root / HERE.name / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    setup_base = _process_age_s() - (time.perf_counter() - _T_START)

    bench, cell, doc, mix = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from o3r_bench.harness import run_cell

    out = run_cell(doc, mix, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start=_T_START - setup_base)

    if args.trace:
        summary = out["summary"]
        metrics = {}
        for m in metrics_of(bench, cell["name"], "per_layer"):
            value = reader(m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(out["device"], busy_s=summary["busy_s"], window_s=summary["wall_s"])
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, cell["name"], "end_to_end")}
        device = out["device"]
    print(json.dumps({k: out[k] for k in ("frames", "keyframes", "window_s", "setup_s",
                                          "ate_m", "ate_prior_m", "check_s",
                                          "captures_in_setup")
                      if k in out}
                     | {"late_ms_max": out.get("late_ms_max"), "step_graph": out["step_graph"],
                        "plan": vars(out["plan"])}), file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    checks = {name: {"value": out["numbers"].get(name), "limit": limit}
              for name, limit in out["limits"].items()}
    line = {"correct": bool(out["correct"]), "attempted": out["frames"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = {"device_ops": summary["device_top"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    def _timeout(*_):
        print(f"no result within {TIME_LIMIT_S} s", file=sys.stderr, flush=True)
        os._exit(3)

    signal.signal(signal.SIGALRM, _timeout)
    signal.alarm(TIME_LIMIT_S)
    sys.exit(main())
