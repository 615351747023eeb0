"""BENCHMARK.json against the benchmark's contract, every cell resolved to
its files by name, new files picked up without editing any that exist, and
the import guard (CPU)."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from o3r_bench.run import FORBIDDEN, load_cell, metrics_of, reader

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "o3r_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\t\n\r]", text)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    for path in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.startswith("/")
        assert ".." not in path.split("/") and not path.endswith("_torch")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_metric_keys():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1


def test_every_cell_resolves_by_name():
    b = bench()
    pairs = set()
    for w in b["workloads"]:
        _, cell, doc, mix = load_cell(w["name"])
        pairs.add((cell["config"], cell["traffic"]))
        config = next(c for c in b["configs"] if c["name"] == cell["config"])
        assert doc["name"] == config["name"] and doc["reduced"] == config["reduced"]
        assert config["file"].startswith("o3r_bench/configs/")
        assert mix["loop"] in ("closed", "open")
        e2e = [m["name"] for m in metrics_of(b, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = metrics_of(b, w["name"], "per_layer")
        assert layers
        for m in layers:
            module = reader(m["name"])
            assert (module.UNIT, module.LAYER, module.MOVES) == (m["unit"], m["layer"], m["moves"])
            assert m["moves"] in e2e
    assert len(pairs) == len(b["workloads"])
    # every configuration is used by a cell and has a file of its own
    assert {c["name"] for c in b["configs"]} == {c for c, _ in pairs}
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])


def test_new_files_are_found_without_editing(tmp_path):
    """A new configuration, mix and metric reader are new files; only the
    new cell's entry names them."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(PKG / sub, tmp_path / "o3r_bench" / sub)
    doc = json.loads((PKG / "configs" / "survey_512x384_d64.json").read_text())
    doc["name"] = "survey_new"
    (tmp_path / "o3r_bench/configs/survey_new.json").write_text(json.dumps(doc))
    (tmp_path / "o3r_bench/traffic/trickle.json").write_text(json.dumps(
        {"loop": "open", "rate_hz": 5.0, "warmup_frames": 48, "trace_frames": 20}))
    (tmp_path / "o3r_bench/metrics/new_metric_ms.py").write_text(
        'UNIT, LAYER, MOVES = "ms", "entry", "frame_latency_p95_ms"\n'
        'def read(summary):\n    return 1.5\n')
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "survey_new", "source": "x",
                         "file": "o3r_bench/configs/survey_new.json", "reduced": [], "why": "x"})
    b["workloads"].append({"name": "survey.trickle", "config": "survey_new",
                           "traffic": "trickle", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "new_metric_ms", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "entry",
                           "moves": "frame_latency_p95_ms", "workloads": ["survey.trickle"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    _, cell, doc2, mix = load_cell("survey.trickle", root=tmp_path)
    assert doc2["name"] == "survey_new" and mix["rate_hz"] == 5.0
    assert reader("new_metric_ms", root=tmp_path).read({}) == 1.5
    for existing in ("configs/survey_512x384_d64.json", "traffic/flat_out.json",
                     "metrics/k1_roofline_pct.py"):
        assert (tmp_path / "o3r_bench" / existing).read_bytes() == (PKG / existing).read_bytes()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_import_guard(path):
    """No module imports JAX or the JAX package, compared by whole top-level
    names; the plain reference imports nothing of the port either."""
    names = set(_imports(path))
    assert not names & set(FORBIDDEN), names
    if "reference" in path.relative_to(PKG).parts:
        assert "online_3d_reconstruction_tpu_torch" not in names
        assert "o3r_bench" not in names   # the reference stands alone: relative imports
