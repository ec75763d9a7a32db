"""Build and load the port's CUDA kernels (vo_tpu_torch/csrc/*.cu).

Each source compiles with its own nvcc process (all started together) into
an object file, and one link makes ONE shared library with a plain C
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
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (imgs, out, B, H, W, mode, patch, kappa, nms_radius, stream)
    "vo_corner_response_nms": (_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P),
    # (patch, nms_radius, info[7]) — the launch shape of that instance
    "vo_corner_nms_launch_info": (_I, _I, _P),
    # (imgs, corners, out, B, H, W, K, size, stream)
    "vo_extract_patches": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (prev, next, tcorners, scorners, tout, sout, B, H, W, K, tsize, ssize,
    #  pad, stream) — both gathers of one LK level in one launch
    "vo_extract_patch_pairs": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # (tpatch, spatch, tfrac, s_base, guess, flow, cond, err, live, B, K,
    #  radius, tsize, ssize, max_iters, eps2, min_eig_threshold, pos_hi,
    #  stream) — one LK level's solve after its patch pair
    "vo_lk_solve": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    ctypes.c_float, ctypes.c_float, ctypes.c_float, _P),
    # (S, b, x, B, W, nb, S's five strides, b's three, count, stream) — BA's
    # camera system, every lane in one launch
    "vo_ba_solve": (_P, _P, _P, _I, _I, _I, *(ctypes.c_longlong,) * 8, _P, _P),
    # (stream) — an empty kernel, the launch-latency floor
    "vo_empty_launch": (_P,),
    # (capturing stream, device bool, branch graph, IF node out, body graph
    # out) — an IF node in the graph being captured (csrc/graph_cond.cu)
    "vo_graph_if_node": (_P, _P, _P, _P, _P),
    # (boundary, ring, seq, rows, cols, src, n, dst, stream) — a span mark on
    # the card's clock (csrc/spans.cu)
    "vo_span_mark_launch": (_I, _P, _P, _I, _I, _P, _I, _I, _P),
    # (out[2], stream) — two readings of the card's clock, for the calibration
    "vo_span_clock": (_P, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir(extra_flags: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
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


def build(extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile the sources if this hash has no library yet; returns its path.
    `extra_flags` (e.g. a -D that retiles a kernel for a tuning run) are part
    of the hash, so each set of flags has a library of its own. The
    compiler's report (registers, shared memory, spills) is kept in build.log
    beside the library."""
    out_dir = build_dir(extra_flags)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Work under private names, then rename: a concurrent process never loads
    # a half-written library.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for src in sources():
            obj = str(Path(tmp) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            text, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(text)
        if not failed:
            so = str(Path(tmp) / LIB_NAME)
            cmd = [nvcc, "-shared", "-o", so, *(obj for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-4000:])
        os.replace(so, lib)
    return lib


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and set its argtypes."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes set."""
    return load(build())
