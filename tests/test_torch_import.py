"""Import hygiene of the PyTorch port: its whole import graph, and
chip_smoke.py, load no JAX (the machine with the card has none). Run in
fresh subprocesses, because this suite's conftest imports jax in-process."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# modules the walk must reach (the window-BA slice and the profiler among
# them), relative to the package
_REQUIRED = ("ba.problem", "ba.schur", "ba.testing", "ba.device_tracks", "ba.window",
             "utils.roofline", "tools.profile_stages", "stereo.sgm_cuda",
             "runtime.pipeline")

_WALK = """
import importlib, pkgutil, sys
import online_3d_reconstruction_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
missing = [r for r in REQUIRED if pkg.__name__ + "." + r not in names]
assert not missing, missing
assert len(names) >= 30, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
print("ok", len(names))
"""


def test_port_import_graph_loads_no_jax():
    script = f"REQUIRED = {_REQUIRED!r}\n" + _WALK
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_only_the_reuse_modules_name_the_jax_package():
    """chip_smoke.py and the port reach the JAX package's jax-free modules
    only through the port's config, io and utils.metrics."""
    pattern = re.compile(r"\bonline_3d_reconstruction_tpu\.")
    reuse = {Path("config.py"), Path("io/__init__.py"), Path("utils/metrics.py")}
    port = ROOT / "online_3d_reconstruction_tpu_torch"
    files = [ROOT / "chip_smoke.py"] + [p for p in sorted(port.rglob("*.py"))
                                        if p.relative_to(port) not in reuse]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_chip_smoke_fails_without_card_and_alone(tmp_path):
    """Here there is no card: chip_smoke.py must exit non-zero and print no
    result, both in the checkout and as a lone file in an empty directory."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env={**os.environ, "PYTHONPATH": ""})
        assert proc.returncode != 0, proc.stdout
        assert '"ok": true' not in proc.stdout
