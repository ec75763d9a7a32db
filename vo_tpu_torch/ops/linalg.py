"""Small dense SPD solves by hand-written Cholesky — port of
vo_tpu/ops/linalg.py, plus guarded eigh/svd wrappers that never read the
device from the host.

The 6x6 PnP Gauss-Newton step and the (W, W, 6, 6) reduced camera system of
windowed BA are SPD by construction (J^T J + damping + gauge), so they are
solved by Cholesky in full f32 — not by `torch.linalg.solve` (LU), whose
reduced-precision variant cost the reference 48% headline ATE
(vo_tpu/ops/pnp.py:415-422). The unrolled loops keep the reference's
subtraction order element for element; `chol_small` vectorizes each column
over its rows.
"""

from __future__ import annotations

import torch

from vo_tpu_torch.ops import cusolver


def chol_small(A: torch.Tensor, n: int, eps: float = 1e-20) -> torch.Tensor:
    """Lower Cholesky factor of a static-size SPD matrix (..., n, n).
    `eps` floors the pivot so an exactly-singular block yields large-but-
    finite entries instead of NaN (callers gate on isfinite afterwards)."""
    cols = []  # cols[k]: (..., n - k) entries L[k:, k]
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            s = s - cols[k][..., j - k:] * cols[k][..., j - k, None]
        d = torch.sqrt(torch.clamp(s[..., :1], min=eps))
        cols.append(torch.cat([d, s[..., 1:] * (1.0 / d)], dim=-1))
    zeros = torch.zeros_like(A[..., :, 0])
    full = [torch.cat([zeros[..., :j], c], dim=-1) for j, c in enumerate(cols)]
    return torch.stack(full, dim=-1)


def tri_solve_lower(L: torch.Tensor, B: torch.Tensor, n: int) -> torch.Tensor:
    """Solve L X = B with L (..., n, n) lower-triangular, B (..., n, m)."""
    X = []
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * X[k]
        X.append(s / L[..., i, i, None])
    return torch.stack(X, dim=-2)


def tri_solve_lower_t(L: torch.Tensor, B: torch.Tensor, n: int) -> torch.Tensor:
    """Solve L^T X = B (back substitution against the same lower factor)."""
    X = [None] * n
    for i in reversed(range(n)):
        s = B[..., i, :]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * X[k]
        X[i] = s / L[..., i, i, None]
    return torch.stack(X, dim=-2)


def spd_solve_small(A: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """SPD solve A x = b for static tiny n. A (..., n, n), b (..., n)."""
    L = chol_small(A, n)
    y = tri_solve_lower(L, b[..., None], n)
    return tri_solve_lower_t(L, y, n)[..., 0]


def spd_solve_blocked(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD block system sum_j S[i,j] x_j = b_i by block-Cholesky.
    S: (..., W, W, B, B), only the lower block triangle is read; b:
    (..., W, B). Leading axes are independent systems (lanes)."""
    W, B = S.shape[-4], S.shape[-2]

    def t(M):
        return M.transpose(-1, -2)

    def mv(M, v):
        return M @ v if v.ndim == 1 else (M @ v[..., None])[..., 0]

    L = [[None] * W for _ in range(W)]
    for j in range(W):
        D = S[..., j, j, :, :]
        for k in range(j):
            D = D - L[j][k] @ t(L[j][k])
        Ljj = chol_small(D, B)
        L[j][j] = Ljj
        for i in range(j + 1, W):
            M = S[..., i, j, :, :]
            for k in range(j):
                M = M - L[i][k] @ t(L[j][k])
            # X = M Ljj^{-T}  <=>  Ljj X^T = M^T
            L[i][j] = t(tri_solve_lower(Ljj, t(M), B))
    y = [None] * W
    for i in range(W):
        s = b[..., i, :]
        for k in range(i):
            s = s - mv(L[i][k], y[k])
        y[i] = tri_solve_lower(L[i][i], s[..., None], B)[..., 0]
    x = [None] * W
    for i in reversed(range(W)):
        s = y[i]
        for k in range(i + 1, W):
            s = s - mv(t(L[k][i]), x[k])
        x[i] = tri_solve_lower_t(L[i][i], s[..., None], B)[..., 0]
    return torch.stack(x, dim=-2)


def _finite_rows(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    ok = torch.isfinite(A).flatten(-2).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return ok, torch.where(ok[..., None, None], A, eye)


def eigh_finite(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """eigh (ascending) that returns NaN for a batch element holding a
    non-finite entry instead of raising, as LAPACK-through-XLA does for the
    reference. On the card: the cuSOLVER routine torch.linalg.eigh runs
    (XsyevBatched: the same bits, f32 or f64) with its error flag left on
    the device (ops/cusolver.py), so a CUDA graph can hold it; any other
    dtype raises there. On the CPU: torch.linalg.eigh (LAPACK), the plain
    version."""
    ok, A = _finite_rows(A)
    vals, vecs = cusolver.syev_batched(A) if A.is_cuda else torch.linalg.eigh(A)
    nan = float("nan")
    return (torch.where(ok[..., None], vals, nan),
            torch.where(ok[..., None, None], vecs, nan))


def svd_finite(A: torch.Tensor, full_matrices: bool = True):
    """svd (square matrices, so `full_matrices` changes nothing) with the
    same non-finite guard as `eigh_finite`. On the card: cuSOLVER's
    gesvdjBatched (S or D, f32 or f64) with torch.linalg.svd's parameters
    and no host read; on the CPU: torch.linalg.svd."""
    ok, A = _finite_rows(A)
    U, S, Vh = (cusolver.gesvdj_batched(A) if A.is_cuda
                else torch.linalg.svd(A, full_matrices=full_matrices))
    nan = float("nan")
    return (torch.where(ok[..., None, None], U, nan),
            torch.where(ok[..., None], S, nan),
            torch.where(ok[..., None, None], Vh, nan))
