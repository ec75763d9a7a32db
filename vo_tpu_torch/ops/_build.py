"""Build and load the port's CUDA kernels (vo_tpu_torch/csrc/*.cu).

All sources compile with nvcc into ONE shared library with a plain C
interface, loaded with ctypes — no PyTorch headers, so a cold build takes
seconds. The library lands in `vo_tpu_torch/build/<hash>/` (git-ignored),
keyed by a hash of the sources and flags: a changed source rebuilds, an
unchanged one is loaded as is. Nothing here runs at import time; the first
kernel launch calls `library()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"
LIB_NAME = "libvo_kernels.so"

# sm_90a: Hopper with its architecture-specific features. -fmad=false keeps
# every multiply-add rounded as the plain PyTorch oracle rounds it (a
# contracted FMA could flip a near-tie between NMS neighbours in K1).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (imgs, out, B, H, W, mode, patch, kappa, nms_radius, stream)
    "vo_corner_response_nms": (_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P),
    # (imgs, corners, out, B, H, W, K, size, stream)
    "vo_extract_patches": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (stream) — an empty kernel, the launch-latency floor
    "vo_empty_launch": (_P,),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build() -> Path:
    """Compile the sources if this hash has no library yet; returns its path.
    The compiler's report (registers, shared memory, spills) is kept in
    build.log beside the library."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # Compile to a private name, then rename: a concurrent process never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
