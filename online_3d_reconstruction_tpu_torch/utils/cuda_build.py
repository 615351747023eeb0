"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, into ``build/kernels/`` at the
root of the checkout; the library's file name carries a hash of the sources
and flags, so an edited ``.cu`` file builds a new library. Nothing here runs
at import time, and nothing falls back: a missing ``nvcc`` or a failed
compile raises.
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
from typing import Optional

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
SOURCES = ("sgm_aggregate.cu", "speckle_run_total.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
# seconds the nvcc build took in this process (0.0: loaded an existing build)
build_seconds: Optional[float] = None


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libo3r_kernels_{digest.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)   # atomic: a concurrent build never sees a torn file


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
    lib = ctypes.CDLL(str(target))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.o3r_sgm_path.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, f32, f32,
                                 ptr]
    lib.o3r_sgm_path.restype = i32
    lib.o3r_run_total.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.o3r_run_total.restype = i32
    lib.o3r_cuda_error_string.argtypes = [i32]
    lib.o3r_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.o3r_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
