"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, into ``build/kernels/`` at the
root of the checkout: one ``nvcc`` per source, all started together, then
one link. The library's file name carries a hash of the sources and flags,
so an edited ``.cu`` file builds a new library. Nothing here runs at import
time, and nothing falls back: a missing ``nvcc`` or a failed compile raises.
``O3R_NVCC_FLAGS`` in the environment adds flags (a probe build with a
``-D``, ``-Xptxas -v``); what the compilers printed is kept in ``build_log``.
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
SOURCES = ("sgm_aggregate.cu", "speckle_run_total.cu", "sgm_scan_pair.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
# seconds the nvcc build took in this process (0.0: loaded an existing build)
build_seconds: Optional[float] = None
# what nvcc printed for each source of a build that succeeded
build_log: str = ""


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
    lib.o3r_sgm_aggregate.argtypes = [ptr, ptr, ptr, i32, i32, f32, f32, i32, ptr]
    lib.o3r_sgm_aggregate.restype = i32
    lib.o3r_sgm_unpack16.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
    lib.o3r_sgm_unpack16.restype = i32
    lib.o3r_run_total.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.o3r_run_total.restype = i32
    for name in ("o3r_scan_fwd", "o3r_scan_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32, i32, i32, i32, f32, f32, ptr]
        fn.restype = i32
    lib.o3r_cuda_error_string.argtypes = [i32]
    lib.o3r_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.o3r_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
