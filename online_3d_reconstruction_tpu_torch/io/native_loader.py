"""ctypes bindings for the native C++ IO runtime (native/libo3r_io.so).

The reference's data layer is native C++ (SURVEY.md §2.1 C2); ours is too:
PGM/PPM/npy decoding and an ordered multi-threaded prefetcher live in
``native/src/o3r_io.cpp``. This wrapper loads the shared library (building
it on first use if a compiler is available) and exposes numpy-facing
functions; callers fall back to the pure-Python path when the library is
unavailable (``available()`` -> False).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libo3r_io.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _O3RImage(ctypes.Structure):
    _fields_ = [
        ("height", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("is_float", ctypes.c_int32),
        ("data", ctypes.c_void_p),
    ]


def _build() -> bool:
    script = os.path.join(_NATIVE_DIR, "build.sh")
    if not os.path.exists(script):
        return False
    try:
        subprocess.run(["sh", script], check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, OSError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.o3r_read_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(_O3RImage)]
    lib.o3r_read_image.restype = ctypes.c_int32
    lib.o3r_image_free.argtypes = [ctypes.POINTER(_O3RImage)]
    lib.o3r_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.o3r_prefetch_create.restype = ctypes.c_void_p
    lib.o3r_prefetch_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_O3RImage)]
    lib.o3r_prefetch_next.restype = ctypes.c_int32
    lib.o3r_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _to_numpy(img: _O3RImage, lib: ctypes.CDLL) -> np.ndarray:
    count = img.height * img.width * img.channels
    ctype = ctypes.c_float if img.is_float else ctypes.c_uint8
    buf = ctypes.cast(img.data, ctypes.POINTER(ctype * count)).contents
    arr = np.frombuffer(buf, dtype=np.float32 if img.is_float else np.uint8).copy()
    lib.o3r_image_free(ctypes.byref(img))
    shape = (img.height, img.width) if img.channels == 1 else (
        img.height, img.width, img.channels
    )
    return arr.reshape(shape)


def read_image(path: str) -> np.ndarray:
    """Decode a PGM/PPM/npy image via the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    img = _O3RImage()
    rc = lib.o3r_read_image(path.encode(), ctypes.byref(img))
    if rc != 0:
        raise IOError(f"o3r_read_image({path}) failed with code {rc}")
    return _to_numpy(img, lib)


class NativePrefetcher:
    """Ordered decoded-frame stream with C++ worker threads reading ahead."""

    def __init__(self, paths: Sequence[str], depth: int = 4, threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._paths_keepalive = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(paths))(*self._paths_keepalive)
        self._handle = lib.o3r_prefetch_create(arr, len(paths), depth, threads)
        if not self._handle:
            raise RuntimeError("o3r_prefetch_create failed")

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            img = _O3RImage()
            rc = self._lib.o3r_prefetch_next(self._handle, ctypes.byref(img))
            if rc == 1:
                return
            if rc != 0:
                raise IOError(f"prefetch decode failed with code {rc}")
            yield _to_numpy(img, self._lib)

    def close(self) -> None:
        if self._handle:
            self._lib.o3r_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
