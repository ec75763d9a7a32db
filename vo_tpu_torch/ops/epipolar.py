"""Two-view epipolar geometry: 8-point F, essential-matrix decomposition,
cheirality-voted relative pose — port of vo_tpu/ops/epipolar.py.

eigh/svd sign conventions differ between LAPACK and cuSOLVER; every output
here is invariant to them (F up to sign, the rank-2 and essential
projections, the four-candidate set and its cheirality vote) — also per
lane, when the inputs carry a leading lane axis ((B, N, 2) points, (B, 3, 3)
matrices, one sampler per lane).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_tpu_torch.geom.points import device_vector, lift, normalize_points, to_homogeneous
from vo_tpu_torch.ops.linalg import eigh_finite, svd_finite
from vo_tpu_torch.ops.ransac import (
    RansacResult,
    Samplers,
    pick,
    where_lane,
    num_iterations,
    ransac,
)
from vo_tpu_torch.ops.triangulate import triangulate_dlt


def fundamental_8point(
    pts1: torch.Tensor, pts2: torch.Tensor, weight: torch.Tensor | None = None
) -> torch.Tensor:
    """Normalized 8-point F. pts (..., N, 2), N >= 8 -> (..., 3, 3), with
    the Frobenius norm scaled to 1. `weight` (..., N) gives the masked
    all-inlier refit."""
    n1, T1 = normalize_points(pts1, weight)
    n2, T2 = normalize_points(pts2, weight)
    h1 = to_homogeneous(n1)
    h2 = to_homogeneous(n2)
    # Rows of A: kron(x2, x1) so that A f = 0 encodes x2^T F x1 = 0.
    A = (h2[..., :, :, None] * h1[..., :, None, :]).flatten(-2)  # (..., N, 9)
    Aw = A if weight is None else A * weight[..., :, None]
    _, vecs = eigh_finite(Aw.transpose(-1, -2) @ A)
    F = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    U, S, Vh = svd_finite(F, full_matrices=False)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = (U * S[..., None, :]) @ Vh
    F = T2.transpose(-1, -2) @ F @ T1
    norm = torch.linalg.matrix_norm(F, keepdim=True)
    return F / torch.clamp(norm, min=1e-20)


def sampson_error(F: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance in squared pixels. F (..., 3,
    3) against pts (..., N, 2) -> (..., N); the leading axes broadcast."""
    h1 = to_homogeneous(pts1)
    h2 = to_homogeneous(pts2)
    Fx1 = (F[..., None, :, :] @ h1[..., None])[..., 0]  # (..., N, 3)
    Ftx2 = (F.transpose(-1, -2)[..., None, :, :] @ h2[..., None])[..., 0]
    num = (h2 * Fx1).sum(dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-20)


def fundamental_ransac(
    key: Samplers,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    valid: torch.Tensor | None = None,
    inlier_threshold_px: float = 1.0,
    outlier_ratio: float = 0.5,
    confidence: float = 0.999,
    num_hypotheses: int | None = None,
) -> RansacResult:
    """RANSAC 8-point F on fixed-capacity (..., N, 2) points with `valid`;
    threshold on Sampson distance in px, then a refit on all inliers."""
    n = pts1.shape[-2]
    h = num_hypotheses or num_iterations(confidence, outlier_ratio, 8)

    def model_fn(sample):
        s1, s2 = sample
        F = fundamental_8point(s1, s2)
        return F, torch.isfinite(F).flatten(-2).all(dim=-1)

    def error_fn(F, data):
        d1, d2 = data  # (..., N, 2) against F (..., C, 3, 3)
        return sampson_error(F, d1.unsqueeze(-3), d2.unsqueeze(-3))

    res = ransac(
        key, (pts1, pts2), num_points=n, sample_size=8, num_hypotheses=h,
        model_fn=model_fn, error_fn=error_fn,
        inlier_threshold=inlier_threshold_px**2, valid=valid,
    )
    w = res.inliers.to(pts1.dtype)
    F_refit = fundamental_8point(pts1, pts2, weight=w)
    ok = torch.isfinite(F_refit).flatten(-2).all(dim=-1) & (res.num_inliers >= 8)
    F = where_lane(ok, F_refit, res.model)
    errors = sampson_error(F, pts1, pts2)
    inl = errors < inlier_threshold_px**2
    if valid is not None:
        inl = inl & valid
    return RansacResult(model=F, inliers=inl, num_inliers=inl.sum(dim=-1), errors=errors)


def essential_from_fundamental(
    F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor
) -> torch.Tensor:
    """E = K2^T F K1, projected onto the essential manifold."""
    E = K2.transpose(-1, -2) @ F @ K1
    U, S, Vh = svd_finite(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    S_fix = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * S_fix[..., None, :]) @ Vh


class RelativePose(NamedTuple):
    T_21: torch.Tensor  # (..., 4, 4) transform frame1 -> frame2 ([R|t] with unit t)
    points1: torch.Tensor  # (..., N, 3) triangulated points in frame-1 coordinates
    good: torch.Tensor  # (..., N) bool cheirality mask (positive depth both views)


def decompose_essential(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E (..., 3, 3) -> (..., 4, 3, 3) rotation candidates paired with
    (..., 4, 3) translations."""
    U, _, Vh = svd_finite(E)
    detU = torch.linalg.det(U)
    detV = torch.linalg.det(Vh)
    one = torch.ones_like(detU)
    U = U * torch.stack([one, one, detU], dim=-1)[..., None, :]
    Vh = Vh * torch.stack([one, one, detV], dim=-1)[..., :, None]
    # Written on the device (no host copy, which a CUDA graph cannot hold).
    W = device_vector([0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                      E.device, E.dtype).reshape(3, 3)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-20)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def relative_pose_from_essential(
    E: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    weight: torch.Tensor | None = None,
) -> RelativePose:
    """Pick the E decomposition with the most points in front of both
    cameras (`weight` masks the vote) and triangulate all points with it.
    pts are PIXEL coordinates."""
    Rs, ts = decompose_essential(E)  # (..., 4, 3, 3), (..., 4, 3)
    eye34 = torch.cat([torch.eye(3, dtype=E.dtype, device=E.device),
                       torch.zeros((3, 1), dtype=E.dtype, device=E.device)], dim=1)
    P1 = K1 @ eye34  # (..., 3, 4)
    P2 = lift(K2, Rs.ndim) @ torch.cat([Rs, ts[..., None]], dim=-1)  # (..., 4, 3, 4)
    lead = E.shape[:-2]
    n = pts1.shape[-2]
    X1_all = triangulate_dlt(
        P1[..., None, None, :, :].expand(lead + (4, n, 3, 4)),
        P2[..., :, None, :, :].expand(lead + (4, n, 3, 4)),
        pts1.unsqueeze(-3).expand(lead + (4, n, 2)),
        pts2.unsqueeze(-3).expand(lead + (4, n, 2)),
    )  # (..., 4, N, 3) frame-1 coordinates
    z1 = X1_all[..., 2]
    z2 = (Rs[..., :, None, 2, :] * X1_all).sum(dim=-1) + ts[..., :, None, 2]
    front_all = (z1 > 0) & (z2 > 0)
    votes = front_all if weight is None else front_all & weight.unsqueeze(-2).bool()
    best = torch.argmax(votes.sum(dim=-1), dim=-1)
    T = torch.zeros(lead + (4, 4), dtype=E.dtype, device=E.device)
    T[..., :3, :3] = pick(Rs, best)
    T[..., :3, 3] = pick(ts, best)
    T[..., 3, 3] = 1.0
    return RelativePose(T_21=T, points1=pick(X1_all, best), good=pick(front_all, best))
