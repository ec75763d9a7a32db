"""Batched DLT triangulation — port of vo_tpu/ops/triangulate.py.

Each point contributes a 4x4 system from two row-normalized skew-constraint
rows per view; the landmark is the smallest eigenvector of A^T A. The sign of
that eigenvector differs between LAPACK and cuSOLVER, which dehomogenizing
removes.
"""

from __future__ import annotations

import torch

from vo_tpu_torch.geom.points import bmat
from vo_tpu_torch.ops.linalg import eigh_finite


def _dlt_rows(P: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """[u P3 - P1 ; v P3 - P2], row-normalized. P (..., 3, 4), uv (..., 2)
    -> (..., 2, 4)."""
    r0 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    rows = torch.stack([r0, r1], dim=-2)
    norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    return rows / torch.clamp(norm, min=1e-20)


def _guard(w: torch.Tensor, tiny: float) -> torch.Tensor:
    """w with |w| < tiny replaced by +-tiny in w's dtype (a where of two
    Python numbers would round them to f32)."""
    return torch.where(w.abs() < tiny, torch.where(w < 0, torch.full_like(w, -tiny),
                                                   torch.full_like(w, tiny)), w)


def triangulate_dlt(
    P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor
) -> torch.Tensor:
    """uv1, uv2: (..., N, 2); P1, P2: one matrix for all points (..., 3, 4)
    or one per point (..., N, 3, 4) -> (..., N, 3) points in the frame the
    projection matrices map from. Leading axes are lanes."""
    _, vecs = eigh_finite(dlt_system(P1, P2, uv1, uv2))  # ascending eigenvalues
    return dlt_points(vecs)


def dlt_system(
    P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor
) -> torch.Tensor:
    """The (..., N, 4, 4) A^T A of `triangulate_dlt`, before its eigh. The
    step splits there: eigh checks its result on the host, which a CUDA
    graph cannot hold."""
    if P1.ndim == uv1.ndim:
        P1 = P1.unsqueeze(-3).expand(uv1.shape[:-1] + (3, 4))
    if P2.ndim == uv2.ndim:
        P2 = P2.unsqueeze(-3).expand(uv2.shape[:-1] + (3, 4))
    A = torch.cat([_dlt_rows(P1, uv1), _dlt_rows(P2, uv2)], dim=-2)  # (N, 4, 4)
    return A.transpose(-1, -2) @ A


def dlt_points(vecs: torch.Tensor) -> torch.Tensor:
    """Points from the eigenvectors (..., N, 4, 4) of `dlt_system`, ascending:
    the first, dehomogenized."""
    X_h = vecs[..., :, 0]
    return X_h[..., :3] / _guard(X_h[..., 3:4], 1e-12)


def reprojection_error(P: torch.Tensor, X: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Euclidean pixel reprojection error. X (..., N, 3), uv (..., N, 2); P
    one matrix (3, 4), one per lane (B, 3, 4) or one per point (..., N, 3, 4)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    p = (bmat(P, Xh) @ Xh[..., None])[..., 0]
    return torch.linalg.vector_norm(p[..., :2] / _guard(p[..., 2:3], 1e-12) - uv, dim=-1)


def depths_in_frame(T_cw: torch.Tensor, X_w: torch.Tensor) -> torch.Tensor:
    """z-depth of world points in a camera frame. T_cw: (..., 4, 4), X: (..., 3)."""
    return (T_cw[..., 2, :3] * X_w).sum(-1) + T_cw[..., 2, 3]
