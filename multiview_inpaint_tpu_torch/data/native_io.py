"""ctypes bindings for the native data-IO library (``native/dataio.cpp``).

Port of ``multiview_inpaint_tpu/data/native_io.py``:

- ``decode_png``: a PNG file -> RGB8 numpy (PIL where the native library
  is missing or refuses the file);
- ``PrefetchLoader``: whole-file prefetch and decode on a pthread pool,
  so a loader can overlap the next frames' decode with the current step.

The library is built from ``native/dataio.cpp`` at first use, with the
flags of ``native/Makefile`` (``g++ -O2 -std=c++17 -fPIC -shared ... -lz
-lpthread``), into ``build/native/`` at the root of the checkout, under a
name that carries a hash of the source and the flags; a lock file keeps
concurrent processes from building it twice. The committed
``native/libmvi_dataio.so`` is never loaded and nothing is written into
``native/``. Where no compiler or no zlib is found, everything falls back
to PIL, as the JAX module does; ``build`` raises with the compiler's
message for a caller that must know why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dataio.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-lz", "-lpthread")

_libs: dict = {}
_lock = threading.Lock()


def lib_path(build_dir=BUILD_DIR) -> Path:
    """Where ``build`` puts the library for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return Path(build_dir) / f"libmvi_dataio-{h.hexdigest()[:12]}.so"


def build(build_dir=BUILD_DIR) -> Path:
    """Compile the library into ``build_dir`` unless it is there; returns
    its path. Raises ``subprocess.CalledProcessError`` (with the
    compiler's stderr) or ``OSError`` (no compiler) when it cannot."""
    out = lib_path(build_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                            *LIBS], check=True, capture_output=True,
                           text=True)
            os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.mvi_png_info.restype = ctypes.c_int
    lib.mvi_png_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.mvi_png_decode_rgb8.restype = ctypes.c_int
    lib.mvi_png_decode_rgb8.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int]
    lib.mvi_loader_create.restype = ctypes.c_void_p
    lib.mvi_loader_create.argtypes = [ctypes.c_int]
    lib.mvi_loader_submit.restype = None
    lib.mvi_loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_char_p]
    lib.mvi_loader_take_rgb8.restype = ctypes.c_int
    lib.mvi_loader_take_rgb8.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mvi_loader_destroy.restype = None
    lib.mvi_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def load(build_dir=BUILD_DIR) -> Optional[ctypes.CDLL]:
    """The bound library (built at first use), or None where it cannot be
    built or loaded; the answer is kept for the process."""
    key = str(build_dir)
    with _lock:
        if key not in _libs:
            try:
                _libs[key] = _bind(build(build_dir))
            except (OSError, subprocess.CalledProcessError):
                _libs[key] = None
        return _libs[key]


def native_available(build_dir=BUILD_DIR) -> bool:
    return load(build_dir) is not None


def _pil_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def decode_png(path: str, build_dir=BUILD_DIR) -> np.ndarray:
    """PNG file -> [H, W, 3] uint8 (native; PIL fallback)."""
    lib = load(build_dir)
    if lib is None:
        return _pil_rgb(path)
    with open(path, "rb") as f:
        data = f.read()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.mvi_png_info(data, len(data), ctypes.byref(w),
                        ctypes.byref(h)) != 0:
        return _pil_rgb(path)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.mvi_png_decode_rgb8(data, len(data),
                               out.ctypes.data_as(ctypes.c_char_p),
                               w.value, h.value) != 0:
        return _pil_rgb(path)
    return out


class PrefetchLoader:
    """Threaded native file prefetcher: submit paths, take decoded RGB
    (``decode_png`` at ``take`` without the native library)."""

    def __init__(self, n_threads: int = 4, max_bytes: int = 4096 * 4096 * 3,
                 build_dir=BUILD_DIR):
        self._handle = None
        self._lib = load(build_dir)
        self._build_dir = build_dir
        self._max_bytes = max_bytes
        self._next_id = 0
        self._fallback = {}
        self._handle = (self._lib.mvi_loader_create(n_threads)
                        if self._lib is not None else None)

    def submit(self, path: str) -> int:
        job = self._next_id
        self._next_id += 1
        if self._handle is not None:
            self._lib.mvi_loader_submit(self._handle, job,
                                        path.encode("utf-8"))
        else:
            self._fallback[job] = path
        return job

    def take(self, job: int) -> np.ndarray:
        if self._handle is None:
            return decode_png(self._fallback.pop(job), self._build_dir)
        buf = np.empty((self._max_bytes,), np.uint8)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.mvi_loader_take_rgb8(
            self._handle, job, buf.ctypes.data_as(ctypes.c_char_p),
            self._max_bytes, ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"native loader failed for job {job} (rc={rc})")
        return buf[:h.value * w.value * 3].reshape(h.value, w.value, 3)

    def close(self):
        if self._handle is not None:
            self._lib.mvi_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
