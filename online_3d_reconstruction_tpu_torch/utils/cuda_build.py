"""Build, load and launch the package's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, into ``build/kernels/`` at the
root of the checkout: one ``nvcc`` per source, all started together, then
one link. The library's file name carries a hash of the sources and flags,
so an edited ``.cu`` file builds a new library. Nothing here runs at import
time, and nothing falls back: a missing ``nvcc`` or a failed compile raises.
``O3R_NVCC_FLAGS`` in the environment adds flags (a probe build with a
``-D``, ``-Xptxas -v``); what the compilers printed is kept in ``build_log``.
``on_card`` and ``launch`` are the wrappers' device policy and launch.
``launch_counts`` is the one registry of kernel launches: each wrapper adds
one where it launches its kernel (K5: one a reduction), never on the CPU,
so a run can show that its main path went through the kernels; the step
graph adds a capture's counts on each replay, and the program's trace
exports them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
SOURCES = ("sgm_aggregate.cu", "speckle_run_total.cu", "sgm_scan_pair.cu",
           "sgm_scan_pair_bf16.cu", "trace_stamp.cu", "census_cost.cu", "voxel_reduce.cu",
           "ransac_fit.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
# seconds the nvcc build took in this process (0.0: loaded an existing build)
build_seconds: Optional[float] = None
# what nvcc printed for each source of a build that succeeded
build_log: str = ""

# launches by kernel: K1 (``sgm_path``, the half form's also in
# ``sgm_path_half``), K2 (``run_total``), K3 (``scan_fwd``, ``scan_bwd``,
# ``scan_pair``), K4 (``census_cost``), K5 (``voxel_reduce``: one per
# reduction, its three kernels, a stable sort and a cumsum), K6
# (``ransac_draw``) and K7 (``rigid_irls``)
launch_counts: Dict[str, int] = {"sgm_path": 0, "sgm_path_half": 0, "run_total": 0,
                                 "scan_fwd": 0, "scan_bwd": 0, "scan_pair": 0,
                                 "census_cost": 0, "voxel_reduce": 0,
                                 "ransac_draw": 0, "rigid_irls": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _flags() -> tuple:
    return NVCC_FLAGS + tuple(os.environ.get("O3R_NVCC_FLAGS", "").split())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(_flags()).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libo3r_kernels_{digest.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    global build_log
    nvcc, flags = _nvcc(), _flags()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objects = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", obj, str(CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(SOURCES, objects)]
        errors, logs = [], []
        for src, proc in zip(SOURCES, procs):
            out, err = proc.communicate()
            logs.append(f"{src}:\n{out}{err}")
            if proc.returncode != 0:
                errors.append(f"{src} ({proc.returncode}):\n{err}")
        build_log = "\n".join(logs)
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        lib = os.path.join(tmp, target.name)
        proc = subprocess.run([nvcc, *flags, "-shared", "-o", lib, *objects],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, target)   # atomic: a concurrent build never sees a torn file


_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each entry point's arguments (all return a cudaError_t as an int; the last
# argument of a launch is the stream)
SIGNATURES = {
    "o3r_sgm_aggregate": [_PTR, _PTR, _PTR, _I32, _I32, _F32, _F32, _I32, _PTR],
    "o3r_sgm_unpack16": [_PTR, _PTR, _I64, _PTR],
    "o3r_sgm_aggregate_half": [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _F32, _F32, _I32,
                               _PTR],
    "o3r_sgm_finish_half": [_PTR, _PTR, _I64, _I32, _I32, _PTR],
    "o3r_sgm_round_half": [_PTR, _PTR, _I64, _I32, _I32, _PTR],
    "o3r_run_total": [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR],
    "o3r_scan_fwd": [_PTR, _PTR, _I32, _I32, _I32, _I32, _F32, _F32, _PTR],
    "o3r_scan_bwd": [_PTR, _PTR, _I32, _I32, _I32, _I32, _F32, _F32, _PTR],
    "o3r_scan_pair": [_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _F32, _F32, _PTR],
    "o3r_trace_stamp": [_PTR, _PTR, _I64, _I32, _I32, _I32, _I32, _PTR],
    "o3r_census_cost": [_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR],
    "o3r_voxel_keys": [_PTR, _PTR, _PTR, _I64, _F32, _F32, _I64, _PTR],
    "o3r_voxel_heads": [_PTR, _PTR, _I64, _PTR],
    "o3r_voxel_reduce": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _PTR],
    "o3r_ransac_draw": [_PTR, _PTR, _I64, _I64, _I64, _I32, _PTR],
    "o3r_rigid_irls": [_PTR, _PTR, _PTR, _PTR, _PTR, _F32, _I32, _PTR, _PTR, _PTR],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of every entry point ``lib`` has
    (a library built from some of the sources binds those)."""
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I32
    lib.o3r_cuda_error_string.argtypes = [_I32]
    lib.o3r_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash is new."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    target = library_path()
    t0 = time.perf_counter()
    if not target.exists():
        _compile(target)
    build_seconds = time.perf_counter() - t0
    lib = bind(ctypes.CDLL(str(target)))
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.o3r_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (a kernel's wrapper launches the kernel), False
    for a CPU one (it runs the plain version); raises for other devices."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def launch(device: torch.device, entry, *args) -> int:
    """Call a kernel entry point of the library on ``device``'s current
    stream (its last argument); the device context is switched only where
    ``device`` is not the current one, which keeps a launch's host time low."""
    if device.index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
