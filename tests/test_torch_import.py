"""Import hygiene of the PyTorch port: its whole import graph, and
chip_smoke.py, load no JAX and nothing of the JAX package (the machine with
the card has no JAX, and the port stands alone). Run in
fresh subprocesses, because this suite's conftest imports jax in-process."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# modules the walk must reach (the window-BA slice, the profilers, the
# runtime, the disk dataset, the apps and the bench among them), relative to
# the package
_REQUIRED = ("ba.problem", "ba.schur", "ba.testing", "ba.device_tracks", "ba.window",
             "utils.roofline", "utils.imaging", "tools.profile_stages", "tools.profile_sgm",
             "stereo.sgm_cuda",
             "runtime.pipeline", "runtime.prefetch", "runtime.checkpoint",
             "io.dataset", "io.export", "io.calibration", "io.synthetic",
             "io.native_loader", "io.viewer", "config", "utils.metrics",
             "apps.reconstruct", "apps.depth", "apps.ba_solve",
             "parallel.mesh", "parallel.frames", "parallel.ba_sharded",
             "parallel.sgm_sharded", "parallel.voxel_sharded", "parallel.launch",
             "runtime.distributed", "tools.scaling_bench",
             "bench", "tools.profile_steady", "tools.profile_stage_parts")

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
ref = sorted(m for m in sys.modules
             if m.split(".")[0] == "online_3d_reconstruction_tpu")
assert not ref, ref
print("ok", len(names))
"""


def test_port_import_graph_loads_no_jax():
    script = f"REQUIRED = {_REQUIRED!r}\n" + _WALK
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_imports_with_the_jax_package_absent(tmp_path):
    """A copy of the port alone (no JAX package beside it, nothing else of
    the checkout) imports every module it has."""
    shutil.copytree(ROOT / "online_3d_reconstruction_tpu_torch",
                    tmp_path / "online_3d_reconstruction_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = f"REQUIRED = {_REQUIRED!r}\n" + _WALK
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


# the reference's top-level names: the eager configuration classes, then
# the lazy entry points (online_3d_reconstruction_tpu/__init__.py)
_EAGER = ("PipelineConfig", "StereoConfig", "FeatureConfig", "MatchConfig",
          "OdometryConfig", "BAConfig", "MappingConfig", "RuntimeConfig", "load_config")
_LAZY = ("reconstruct", "OnlineReconstructor", "reconstruct_distributed", "sgm_disparity",
         "detect_and_describe", "match_descriptors", "odometry_step", "solve_ba",
         "voxel_downsample", "make_mesh")

_API = """
import sys
import online_3d_reconstruction_tpu_torch as pkg
assert "torch" not in sys.modules, "importing the package imported torch"
assert sorted(n for n, v in vars(pkg).items() if not n.startswith("_")
              and not isinstance(v, type(sys))) == sorted(EAGER)
for name in LAZY:
    assert callable(getattr(pkg, name)), name
assert "torch" in sys.modules
try:
    pkg.no_such_name
except AttributeError as err:
    assert "no_such_name" in str(err)
else:
    raise AssertionError("an unknown name resolved")
print("ok")
"""


def test_package_exports_the_reference_names_lazily():
    """``import online_3d_reconstruction_tpu_torch`` alone leaves ``torch``
    out of ``sys.modules`` and holds the configuration classes; the entry
    points resolve on first use. The names are the reference package's: its
    eager ones are its module's public attributes, and each lazy one
    resolves there too."""
    import online_3d_reconstruction_tpu as ref

    assert sorted(n for n, v in vars(ref).items() if not n.startswith("_")
                  and not isinstance(v, type(sys))) == sorted(_EAGER)
    for name in _LAZY:
        assert callable(getattr(ref, name)), name
    with open(ROOT / "online_3d_reconstruction_tpu" / "__init__.py") as fh:
        source = fh.read()
    assert sorted(re.findall(r'^        "(\w+)": \(', source, re.MULTILINE)) == sorted(_LAZY)
    script = f"EAGER = {_EAGER!r}\nLAZY = {_LAZY!r}\n" + _API
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


_IMPORT = re.compile(
    r"^\s*(?:from\s+(online_3d_reconstruction_tpu|jax|jaxlib)(?:\.[\w.]*)?\s+import\b"
    r"|import\s+(?:[\w.]+\s*,\s*)*(online_3d_reconstruction_tpu|jax|jaxlib)(?:\.[\w.]*)?(?:\s|,|$))",
    re.MULTILINE)


def test_only_the_reuse_modules_name_the_jax_package():
    """No file of the port, nor chip_smoke.py, imports the JAX package or
    jax: the allow-list is empty. Only ``import`` / ``from`` statements
    count; a docstring or a ``replaces=`` string may name a reference file."""
    port = ROOT / "online_3d_reconstruction_tpu_torch"
    files = [ROOT / "chip_smoke.py"] + sorted(port.rglob("*.py"))
    assert len(files) > 40
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if _IMPORT.search(p.read_text())]
    assert not offenders, offenders
    for line in ("from online_3d_reconstruction_tpu.config import X",
                 "    import online_3d_reconstruction_tpu.io as io",
                 "import os, jax", "from jax import numpy"):
        assert _IMPORT.search(line), line
    for line in ("from online_3d_reconstruction_tpu_torch.config import X",
                 'replaces="online_3d_reconstruction_tpu/stereo/sgm_pallas.py:224"',
                 "import online_3d_reconstruction_tpu_torch as pkg"):
        assert not _IMPORT.search(line), line


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
