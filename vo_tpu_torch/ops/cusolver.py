"""cuSOLVER's batched eigen- and singular-value routines, called through
ctypes with their error flags left on the device.

`torch.linalg.eigh` and `torch.linalg.svd` copy their `info` to the host to
check it, which no CUDA graph can hold. This module calls the routines that
PyTorch itself calls for the step's small matrices (4x4 DLT systems, 9x9
8-point systems, 3x3 F and E), from the library PyTorch loaded, with
PyTorch's parameters and column-major layout, and does not read `info`:

- eigh: `cusolverDnXsyevBatched` (lower triangle, default parameters),
  which torch.linalg.eigh (PyTorch 2.11, cuSOLVER 11.7) runs for these
  sizes: the same bits, one matrix or a batch, and nothing on the host
  (its host workspace is empty);
- svd: `cusolverDn{S,D}gesvdjBatched` (tolerance = the dtype's epsilon, 15
  sweeps, sorted), which torch.linalg.svd runs for matrices of at most 32
  rows.

Both take float32 (the step) and float64 (the two-view solve of the
recovery and the bootstrap, models/pipeline.py::two_view_f64); any other
dtype raises. chip_smoke.py and
tests/test_torch_cuda.py hold both to torch.linalg bit for bit at the
step's shapes, in both dtypes.
Non-convergence is the one error left, and it is left unread: the result is
the routine's last iterate (a non-finite input never gets here,
`ops/linalg.py` replaces it by the identity first).

State per device, made at first use: one handle (its stream set to the
current stream at every call, so a call inside a capture runs on the
capturing stream), the routines' parameters, and per (routine, dtype,
shape) the workspace size from `*_bufferSize`, which must not run under capture (a
captured rollout makes its first call of each shape in its warm-up). The
workspace and `info` are allocated at every call from torch's allocator,
as PyTorch does: inside a capture from the graph's pool, so they live as
long as the graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_Z = ctypes.c_size_t
_VECTOR = 1  # CUSOLVER_EIG_MODE_VECTOR
_LOWER = 0  # CUBLAS_FILL_MODE_LOWER (torch.linalg.eigh's default UPLO="L")
# cudaDataType of each dtype: the step is f32, the two-view solve f64.
_DATA_TYPE = {torch.float32: 0, torch.float64: 1}  # CUDA_R_32F, CUDA_R_64F
# gesvdjBatched by dtype: cusolverDn<S|D>gesvdjBatched.
_GESVDJ = {torch.float32: "S", torch.float64: "D"}

_SIGNATURES = {
    "cusolverDnCreate": (_P,),
    "cusolverDnSetStream": (_P, _P),
    "cusolverDnCreateParams": (_P,),
    "cusolverDnCreateGesvdjInfo": (_P,),
    "cusolverDnXgesvdjSetTolerance": (_P, ctypes.c_double),
    "cusolverDnXgesvdjSetMaxSweeps": (_P, _I),
    "cusolverDnXgesvdjSetSortEig": (_P, _I),
    # (handle, params, jobz, uplo, n, typeA, A, lda, typeW, W, compute,
    #  device bytes*, host bytes*, batch)
    "cusolverDnXsyevBatched_bufferSize": (_P, _P, _I, _I, _L, _I, _P, _L, _I, _P, _I,
                                          _P, _P, _L),
    # (handle, params, jobz, uplo, n, typeA, A, lda, typeW, W, compute,
    #  device work, device bytes, host work, host bytes, info, batch)
    "cusolverDnXsyevBatched": (_P, _P, _I, _I, _L, _I, _P, _L, _I, _P, _I, _P, _Z, _P, _Z,
                               _P, _L),
}
# (handle, jobz, m, n, A, lda, S, U, ldu, V, ldv, lwork*, params, batch)
_GESVDJ_SIZE = (_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _I)
# (handle, jobz, m, n, A, lda, S, U, ldu, V, ldv, work, lwork, info, params, batch)
_GESVDJ_CALL = (_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I)
_SIGNATURES.update({f"cusolverDn{t}gesvdjBatched{suffix}": sig
                    for t in _GESVDJ.values()
                    for suffix, sig in (("_bufferSize", _GESVDJ_SIZE), ("", _GESVDJ_CALL))})


def library_path() -> str:
    """The libcusolver that this process's torch loaded, so the routines are
    the very ones `torch.linalg` calls. One small `torch.linalg.eigh` on
    the card first makes torch load it (where it loads it lazily); a
    process whose torch still has none raises: another build of cuSOLVER
    could give other bits."""
    torch.linalg.eigh(torch.ones((1, 1), device="cuda"))
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if "/libcusolver.so" in path:
                return path
    raise RuntimeError("torch has loaded no libcusolver after a torch.linalg.eigh on the "
                       "card: its cuSOLVER routines cannot be called")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _call(name: str, *args) -> None:
    status = getattr(_lib(), name)(*args)
    if status != 0:
        raise RuntimeError(f"{name} failed with cusolverStatus {status}")


class _Device:
    """One device's handle, parameters (gesvdj's by dtype) and workspace
    sizes by shape."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle, self.params = _P(), _P()
        self.gesvdj = {dtype: _P() for dtype in _GESVDJ}
        with torch.cuda.device(device):
            _call("cusolverDnCreate", ctypes.byref(self.handle))
            _call("cusolverDnCreateParams", ctypes.byref(self.params))
            for dtype, info in self.gesvdj.items():
                _call("cusolverDnCreateGesvdjInfo", ctypes.byref(info))
                _call("cusolverDnXgesvdjSetTolerance", info, float(torch.finfo(dtype).eps))
                _call("cusolverDnXgesvdjSetMaxSweeps", info, 15)
                _call("cusolverDnXgesvdjSetSortEig", info, 1)
        self.sizes: dict = {}  # (routine, dtype, n, batch) -> workspace bytes

    def stream(self) -> None:
        _call("cusolverDnSetStream", self.handle,
              _P(torch.cuda.current_stream(self.device).cuda_stream))

    def workspace(self, key: tuple, query) -> tuple[torch.Tensor, int, torch.Tensor]:
        """(workspace, its size, info) for a call of `key` = (routine,
        dtype, n, batch); the size from `query()` (a cuSOLVER size query) on
        first use."""
        size = self.sizes.get(key)
        if size is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"cuSOLVER {key[0]} of a new shape {key[1:]} under "
                                   "capture: call it once outside capture first")
            size = self.sizes[key] = query()
        work = torch.empty(max(size, 1), dtype=torch.uint8, device=self.device)
        return work, size, torch.empty(key[3], dtype=torch.int32, device=self.device)


_DEVICES: dict = {}


def _device(A: torch.Tensor) -> _Device:
    if not A.is_cuda or A.dtype not in _DATA_TYPE:
        raise TypeError(f"cuSOLVER here takes CUDA float32 or float64, got {A.dtype} on "
                        f"{A.device}")
    if A.ndim < 2 or A.shape[-1] != A.shape[-2] or not 0 < A.shape[-1] <= 32:
        raise ValueError(f"square matrices of at most 32 rows, got {tuple(A.shape)}")
    key = A.device.index if A.device.index is not None else torch.cuda.current_device()
    state = _DEVICES.get(key)
    if state is None:
        state = _DEVICES[key] = _Device(torch.device("cuda", key))
    state.stream()
    return state


def _column_major(A: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(B, n, n) buffer whose column-major matrices are A's (A's
    transposes, row-major), and B."""
    n = A.shape[-1]
    buf = A.reshape(-1, n, n).transpose(-1, -2).contiguous()
    return buf, buf.shape[0]


def syev_batched(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """torch.linalg.eigh(A) for symmetric float32 or float64 (..., n, n),
    n <= 32, through `cusolverDnXsyevBatched`: (eigenvalues ascending
    (..., n), eigenvectors as columns (..., n, n)). No host read."""
    state = _device(A)
    n = A.shape[-1]
    vecs, batch = _column_major(A)
    vals = torch.empty((batch, n), dtype=A.dtype, device=A.device)
    t = _DATA_TYPE[A.dtype]
    args = (state.handle, state.params, _VECTOR, _LOWER, n, t, _P(vecs.data_ptr()), n,
            t, _P(vals.data_ptr()), t)

    def query() -> int:
        dev_bytes, host_bytes = _Z(0), _Z(0)
        _call("cusolverDnXsyevBatched_bufferSize", *args, ctypes.byref(dev_bytes),
              ctypes.byref(host_bytes), batch)
        if host_bytes.value:
            raise RuntimeError(f"cusolverDnXsyevBatched asks for {host_bytes.value} bytes "
                               "of host workspace: it would work on the host")
        return dev_bytes.value

    work, size, info = state.workspace(("syev", A.dtype, n, batch), query)
    _call("cusolverDnXsyevBatched", *args, _P(work.data_ptr()), size, None, 0,
          _P(info.data_ptr()), batch)
    return vals.reshape(A.shape[:-1]), vecs.transpose(-1, -2).reshape(A.shape)


def gesvdj_batched(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torch.linalg.svd(A) for square float32 or float64 (..., n, n),
    n <= 32, through `cusolverDn{S,D}gesvdjBatched`: (U, S descending, Vh).
    No host read."""
    state = _device(A)
    routine = f"cusolverDn{_GESVDJ[A.dtype]}gesvdjBatched"
    params = state.gesvdj[A.dtype]
    n = A.shape[-1]
    a, batch = _column_major(A)
    s = torch.empty((batch, n), dtype=A.dtype, device=A.device)
    u = torch.empty((batch, n, n), dtype=A.dtype, device=A.device)
    v = torch.empty((batch, n, n), dtype=A.dtype, device=A.device)
    args = (state.handle, _VECTOR, n, n, _P(a.data_ptr()), n, _P(s.data_ptr()),
            _P(u.data_ptr()), n, _P(v.data_ptr()), n)

    item = A.element_size()

    def query() -> int:
        lwork = _I(0)
        _call(routine + "_bufferSize", *args, ctypes.byref(lwork), params, batch)
        return item * lwork.value  # lwork counts elements

    work, size, info = state.workspace(("gesvdj", A.dtype, n, batch), query)
    _call(routine, *args, _P(work.data_ptr()), size // item, _P(info.data_ptr()), params,
          batch)
    # u and v hold U and V column-major: u is U^T row-major, v is V^T = Vh.
    return u.transpose(-1, -2).reshape(A.shape), s.reshape(A.shape[:-1]), v.reshape(A.shape)
