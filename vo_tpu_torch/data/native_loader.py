"""ctypes bindings of the port's native frame loader (csrc/frame_loader.cc):
PNG/JPEG -> f32 grey decode with libpng/libjpeg, and a C++ decode-ahead
thread ring, so decode stays off the device loop's critical path.

The library is built at first use with g++ (`-O3 -fPIC -std=c++17 -shared
... -lpng -ljpeg -lz -pthread`) into `vo_tpu_torch/build/<source hash>/`
(git-ignored), keyed by a hash of the source and flags, and loaded with
ctypes. Where the compiler or the libraries' headers are missing,
`available()` is False and `build_error()` says why; the loaders then decode
with data/png.py (PNG) or PIL (JPEG).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from vo_tpu_torch.ops._build import BUILD_ROOT, CSRC

SOURCE = CSRC / "frame_loader.cc"
LIB_NAME = "libvoframe.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lz", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this hash has none yet; returns its path.
    Raises RuntimeError with the compiler's message on failure."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build under a private name, then rename: a concurrent process never
    # loads a half-written library.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = Path(tmp) / LIB_NAME
        cmd = [cxx, *CXX_FLAGS, "-o", str(so), str(SOURCE), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
        os.replace(so, lib)
    return lib


def _bind(lib) -> None:
    P, I = ctypes.POINTER, ctypes.c_int
    lib.vo_image_size.argtypes = [ctypes.c_char_p, P(I), P(I)]
    lib.vo_image_size.restype = I
    lib.vo_decode_gray.argtypes = [ctypes.c_char_p, P(ctypes.c_float), I, I]
    lib.vo_decode_gray.restype = I
    lib.vo_prefetch_create.argtypes = [P(ctypes.c_char_p), I, I, I, I, I]
    lib.vo_prefetch_create.restype = ctypes.c_void_p
    lib.vo_prefetch_get.argtypes = [ctypes.c_void_p, I, P(ctypes.c_float)]
    lib.vo_prefetch_get.restype = I
    lib.vo_prefetch_destroy.argtypes = [ctypes.c_void_p]
    lib.vo_prefetch_destroy.restype = None


def load_library():
    """Load (building if needed) the native library, or None if it cannot be
    built or loaded (`build_error()` then says why)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
            _build_error = str(exc)
            return None
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def build_error() -> str | None:
    """Why the library is not available (None when it is, or before the
    first attempt)."""
    return _build_error


def _need():
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    return lib


def image_size(path: str) -> tuple[int, int]:
    """(h, w) of an image file via the native header parse."""
    lib = _need()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.vo_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"cannot read image header: {path}")
    return h.value, w.value


def decode_gray(path: str, hw: tuple[int, int] | None = None) -> np.ndarray:
    """Decode one PNG/JPEG to (h, w) float32 grey levels in [0, 255]."""
    lib = _need()
    h, w = hw if hw is not None else image_size(path)
    out = np.empty((h, w), np.float32)
    if lib.vo_decode_gray(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          h, w) != 0:
        raise IOError(f"native decode failed: {path}")
    return out


class FramePrefetcher:
    """Decode-ahead iterator over equally sized frames.

    A C++ thread pool keeps up to `ring` decoded frames buffered; `get(i)`
    (strictly sequential) blocks only if decode is behind the consumer, and
    may write into a caller's (h, w) f32 buffer (`out`)."""

    def __init__(self, paths: list[str], n_threads: int = 4, ring: int = 8):
        lib = _need()
        if not paths:
            raise ValueError("no paths")
        self._lib = lib
        self.h, self.w = image_size(paths[0])
        self.n = len(paths)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.vo_prefetch_create(arr, len(paths), self.h, self.w, n_threads, ring)
        if not self._handle:
            raise RuntimeError("vo_prefetch_create failed")
        self._next = 0

    def get(self, idx: int, out: np.ndarray | None = None) -> np.ndarray:
        if idx != self._next:
            raise ValueError(f"prefetcher is sequential: expected index {self._next}, got {idx}")
        if out is None:
            out = np.empty((self.h, self.w), np.float32)
        elif out.shape != (self.h, self.w) or out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError(f"out must be a contiguous ({self.h}, {self.w}) float32 array")
        rc = self._lib.vo_prefetch_get(self._handle, idx,
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        # The C++ consumer cursor advances past the frame whether or not its
        # decode succeeded: mirror that before raising, so one bad frame is
        # one error and not a desynchronised ring.
        self._next = idx + 1
        if rc != 0:
            raise IOError(f"prefetch decode failed at frame {idx}")
        return out

    def __iter__(self):
        while self._next < self.n:
            yield self.get(self._next)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vo_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
