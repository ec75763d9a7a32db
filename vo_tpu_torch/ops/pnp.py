"""Perspective-n-Point: Grunert P3P, RANSAC localization, Gauss-Newton pose
refinement — port of vo_tpu/ops/pnp.py.

Every solver takes leading batch axes (the reference vmaps over RANSAC
hypotheses; here the hypothesis axis is written out). Pose convention:
solvers return T_cw (world -> camera, the classic [R|t]).

Lanes: `pnp_ransac` and `refine_pose_gn` take (N, ...) points with K (3, 3)
or, with a leading lane axis, (B, N, ...) points with K (B, 3, 3) and one
sampler per lane; lane b of the result is the unbatched call on lane b.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from vo_tpu_torch.geom.lie import se3_exp
from vo_tpu_torch.geom.points import bmat, inverse, skew, to_homogeneous
from vo_tpu_torch.ops.linalg import spd_solve_small
from vo_tpu_torch.ops.ransac import (
    RansacResult,
    Samplers,
    lane_by_lane,
    num_iterations,
    ransac,
)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _nonzero(x: torch.Tensor, tiny: float) -> torch.Tensor:
    """x with |x| < tiny replaced by sign(x)*tiny (+tiny at exactly 0)."""
    return torch.where(x.abs() < tiny, torch.sign(x) * tiny + (x == 0) * tiny, x)


# ----------------------------------------------------------------------------
# Polynomial solvers (batched, f32-hardened with Newton polish)
# ----------------------------------------------------------------------------

def _solve_cubic_real(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Largest real root of z^3 + a z^2 + b z + c (elementwise)."""
    p = b - a * a / 3.0
    q = 2.0 * a**3 / 27.0 - a * b / 3.0 + c
    m = torch.sqrt(torch.clamp(-p / 3.0, min=1e-20))
    cos_arg = torch.clamp(
        3.0 * q / torch.where(p.abs() < 1e-20, 1e-20, 2.0 * p * m), -1.0, 1.0
    )
    t_trig = 2.0 * m * torch.cos(torch.arccos(cos_arg) / 3.0)
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_card = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    z = torch.where(disc > 0.0, t_card, t_trig) - a / 3.0
    for _ in range(2):
        f = ((z + a) * z + b) * z + c
        df = (3.0 * z + 2.0 * a) * z + b
        z = z - f / torch.where(df.abs() < 1e-20, 1e-20, df)
    return z


def solve_quartic(coeffs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Real roots of A4 x^4 + A3 x^3 + A2 x^2 + A1 x + A0; coeffs (..., 5)
    highest power first -> (roots (..., 4), valid (..., 4))."""
    A4, A3, A2, A1, A0 = (coeffs[..., i] for i in range(5))
    scale = _nonzero(A4, 1e-12)
    a, b, c, d = A3 / scale, A2 / scale, A1 / scale, A0 / scale
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a**3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a**4 / 256.0
    z = torch.clamp(_solve_cubic_real(2.0 * p, p * p - 4.0 * r, -q * q), min=1e-12)
    u = torch.sqrt(z)
    s = 0.5 * (p + z - q / u)
    t = 0.5 * (p + z + q / u)
    d1 = u * u - 4.0 * s
    d2 = u * u - 4.0 * t
    sq1 = torch.sqrt(torch.clamp(d1, min=0.0))
    sq2 = torch.sqrt(torch.clamp(d2, min=0.0))
    y = torch.stack(
        [(-u + sq1) / 2.0, (-u - sq1) / 2.0, (u + sq2) / 2.0, (u - sq2) / 2.0], dim=-1
    )
    valid = torch.stack([d1 >= 0.0, d1 >= 0.0, d2 >= 0.0, d2 >= 0.0], dim=-1)
    x = y - (a / 4.0)[..., None]
    a_, b_, c_, d_ = (v[..., None] for v in (a, b, c, d))
    for _ in range(3):
        f = (((x + a_) * x + b_) * x + c_) * x + d_
        df = ((4.0 * x + 3.0 * a_) * x + 2.0 * b_) * x + c_
        x = x - f / torch.where(df.abs() < 1e-20, 1e-20, df)
    return x, valid


# ----------------------------------------------------------------------------
# P3P (Grunert)
# ----------------------------------------------------------------------------

def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def _triad_frame(p: torch.Tensor) -> torch.Tensor:
    """Right-handed orthonormal frame (columns) from 3 points (..., 3, 3)."""
    e1 = _normalize(p[..., 1, :] - p[..., 0, :])
    u = p[..., 2, :] - p[..., 0, :]
    e2 = _normalize(u - (u * e1).sum(dim=-1, keepdim=True) * e1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def _triad_rigid(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Rigid dst = R @ src + t from EXACT 3-point correspondences (TRIAD)."""
    R = _triad_frame(dst) @ _triad_frame(src).transpose(-1, -2)
    t = dst.mean(dim=-2) - (R @ src.mean(dim=-2)[..., None])[..., 0]
    return _rigid(R, t)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve by Cramer's rule. A (..., 3, 3), b (..., 3)."""
    c0, c1, c2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    c1xc2 = torch.linalg.cross(c1, c2, dim=-1)
    det = (c0 * c1xc2).sum(dim=-1)
    inv_det = torch.where(det.abs() < 1e-20, 0.0, 1.0 / det)
    x0 = (b * c1xc2).sum(dim=-1)
    x1 = (b * torch.linalg.cross(c2, c0, dim=-1)).sum(dim=-1)
    x2 = (b * torch.linalg.cross(c0, c1, dim=-1)).sum(dim=-1)
    return torch.stack([x0, x1, x2], dim=-1) * inv_det[..., None]


def p3p_grunert(X_w: torch.Tensor, rays: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Grunert P3P: world points X_w (..., 3, 3) (rows) and unit bearing rays
    (..., 3, 3) -> up to 4 poses T_cw (..., 4, 4, 4), valid (..., 4)."""
    a2 = ((X_w[..., 1, :] - X_w[..., 2, :]) ** 2).sum(dim=-1)
    b2 = ((X_w[..., 0, :] - X_w[..., 2, :]) ** 2).sum(dim=-1)
    c2 = ((X_w[..., 0, :] - X_w[..., 1, :]) ** 2).sum(dim=-1)
    b2 = torch.clamp(b2, min=1e-12)
    cos_a = (rays[..., 1, :] * rays[..., 2, :]).sum(dim=-1)
    cos_b = (rays[..., 0, :] * rays[..., 2, :]).sum(dim=-1)
    cos_g = (rays[..., 0, :] * rays[..., 1, :]).sum(dim=-1)

    amc = (a2 - c2) / b2
    apc = (a2 + c2) / b2
    A4 = (amc - 1.0) ** 2 - 4.0 * (c2 / b2) * cos_a**2
    A3 = 4.0 * (
        amc * (1.0 - amc) * cos_b
        - (1.0 - apc) * cos_a * cos_g
        + 2.0 * (c2 / b2) * cos_a**2 * cos_b
    )
    A2 = 2.0 * (
        amc**2
        - 1.0
        + 2.0 * amc**2 * cos_b**2
        + 2.0 * ((b2 - c2) / b2) * cos_a**2
        - 4.0 * apc * cos_a * cos_b * cos_g
        + 2.0 * ((b2 - a2) / b2) * cos_g**2
    )
    A1 = 4.0 * (
        -amc * (1.0 + amc) * cos_b
        + 2.0 * (a2 / b2) * cos_g**2 * cos_b
        - (1.0 - apc) * cos_a * cos_g
    )
    A0 = (1.0 + amc) ** 2 - 4.0 * (a2 / b2) * cos_g**2

    v, v_ok = solve_quartic(torch.stack([A4, A3, A2, A1, A0], dim=-1))  # (..., 4)
    # Per-candidate broadcasting of the per-sample scalars.
    a2_, b2_, c2_ = a2[..., None], b2[..., None], c2[..., None]
    ca, cb, cg, amc_ = cos_a[..., None], cos_b[..., None], cos_g[..., None], amc[..., None]

    den_u = _nonzero(2.0 * (cg - v * ca), 1e-9)
    u = ((-1.0 + amc_) * v**2 - 2.0 * amc_ * cb * v + 1.0 + amc_) / den_u
    s1 = torch.sqrt(b2_ / torch.clamp(1.0 + v**2 - 2.0 * v * cb, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    valid = (v_ok & (s1 > 0) & (s2 > 0) & (s3 > 0)
             & torch.isfinite(u) & torch.isfinite(v))

    def polish(si):
        s1_, s2_, s3_ = si[..., 0], si[..., 1], si[..., 2]
        F = torch.stack(
            [
                s2_**2 + s3_**2 - 2.0 * s2_ * s3_ * ca - a2_,
                s1_**2 + s3_**2 - 2.0 * s1_ * s3_ * cb - b2_,
                s1_**2 + s2_**2 - 2.0 * s1_ * s2_ * cg - c2_,
            ],
            dim=-1,
        )
        zero = torch.zeros_like(s1_)
        J = torch.stack(
            [
                torch.stack([zero, 2.0 * (s2_ - s3_ * ca), 2.0 * (s3_ - s2_ * ca)], -1),
                torch.stack([2.0 * (s1_ - s3_ * cb), zero, 2.0 * (s3_ - s1_ * cb)], -1),
                torch.stack([2.0 * (s1_ - s2_ * cg), 2.0 * (s2_ - s1_ * cg), zero], -1),
            ],
            dim=-2,
        )
        delta = _solve3(J, -F)
        return si + torch.where(torch.isfinite(delta), delta, 0.0)

    s_init = torch.stack([s1, s2, s3], dim=-1)  # (..., 4, 3)
    s_pol = s_init
    for _ in range(3):
        s_pol = polish(s_pol)
    keep = torch.isfinite(s_pol).all(dim=-1) & (s_pol > 0).all(dim=-1)
    s = torch.where(keep[..., None], s_pol, s_init)

    Xc = s[..., :, :, None] * rays[..., None, :, :]  # (..., 4, 3, 3)
    T = _triad_rigid(X_w[..., None, :, :].expand(Xc.shape), Xc.to(X_w.dtype))
    return T, valid


def bearing_rays(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit bearing vectors (..., 3) via K^-1 (K (3, 3),
    or per lane (B, 3, 3) against uv (B, ..., 2))."""
    h = to_homogeneous(uv)
    r = (bmat(inverse(K), h) @ h[..., None])[..., 0]
    return r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True), min=1e-20)


def project_T(T_cw: torch.Tensor, K: torch.Tensor, X_w: torch.Tensor) -> torch.Tensor:
    """Project world points with [R|t] and K -> (..., 2) pixels."""
    Xc = (T_cw[..., :3, :3] @ X_w[..., None])[..., 0] + T_cw[..., :3, 3]
    p = (bmat(K, Xc) @ Xc[..., None])[..., 0]
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.where(z < 0, -1e-9, 1e-9), z)
    return p[..., :2] / z


def p3p_solve_sample(
    X4: torch.Tensor, uv4: torch.Tensor, K: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """P3P on points 0..2, disambiguated by point 3. X4 (..., 4, 3), uv4
    (..., 4, 2) -> (T_cw (..., 4, 4), ok (...))."""
    rays = bearing_rays(uv4[..., :3, :], K)
    Ts, valid = p3p_grunert(X4[..., :3, :], rays)  # (..., 4, 4, 4), (..., 4)
    X3 = X4[..., None, 3, :]  # (..., 1, 3)
    uv_hat = project_T(Ts, K, X3)  # (..., 4, 2)
    err = ((uv_hat - uv4[..., None, 3, :]) ** 2).sum(dim=-1)
    z3 = (Ts[..., 2, :3] * X3).sum(dim=-1) + Ts[..., 2, 3]
    u, v = X4[..., 1, :] - X4[..., 0, :], X4[..., 2, :] - X4[..., 0, :]
    cr = torch.linalg.cross(u, v, dim=-1)
    noncollinear = (cr * cr).sum(-1) > 1e-6 * (u * u).sum(-1) * (v * v).sum(-1)
    rigid = (torch.linalg.det(Ts[..., :3, :3]) - 1.0).abs() < 0.1
    err = torch.where(valid & (z3 > 0) & rigid & noncollinear[..., None], err, float("inf"))
    best = torch.argmin(err, dim=-1)
    T = torch.take_along_dim(Ts, best[..., None, None, None], dim=-3)[..., 0, :, :]
    err_best = torch.take_along_dim(err, best[..., None], dim=-1)[..., 0]
    return T, torch.isfinite(err_best)


class PnPResult(NamedTuple):
    T_cw: torch.Tensor  # (..., 4, 4) world -> camera
    inliers: torch.Tensor  # (..., N) bool
    num_inliers: torch.Tensor  # (...) int
    errors: torch.Tensor  # (..., N) pixel reprojection errors of best model


def pnp_budget(num_hypotheses: int | None = None, outlier_ratio: float = 0.5,
               confidence: float = 0.9999) -> int:
    """The hypotheses `pnp_ransac` scores: the given budget, or the static
    count for the outlier ratio and confidence."""
    return num_hypotheses or num_iterations(confidence, outlier_ratio, 4)


def pnp_ransac(
    key: Samplers,
    X_w: torch.Tensor,
    uv: torch.Tensor,
    K: torch.Tensor,
    valid: torch.Tensor | None = None,
    inlier_threshold_px: float = 1.25,
    outlier_ratio: float = 0.5,
    confidence: float = 0.9999,
    num_hypotheses: int | None = None,
    refine_iters: int = 10,
) -> PnPResult:
    """RANSAC-P3P localization + Gauss-Newton refinement on inliers."""
    n = X_w.shape[-2]
    h = pnp_budget(num_hypotheses, outlier_ratio, confidence)

    def model_fn(sample):
        sx, suv = sample
        return p3p_solve_sample(sx, suv, K)

    def error_fn(T, data):  # T (..., C, 4, 4) -> (..., C, N)
        dx, duv = (d.unsqueeze(-3) for d in data)  # (..., 1, N, .)
        T_ = T.unsqueeze(-3)  # (..., C, 1, 4, 4)
        uv_hat = project_T(T_, K, dx)
        z = (T_[..., 2, :3] * dx).sum(dim=-1) + T_[..., 2, 3]
        err = torch.linalg.vector_norm(uv_hat - duv, dim=-1)
        return torch.where(z > 0, err, float("inf"))

    res: RansacResult = ransac(
        key, (X_w, uv), n, 4, h, model_fn, error_fn, inlier_threshold_px, valid
    )
    T = res.model
    if refine_iters:
        T = refine_pose_gn(T, X_w, uv, K, res.inliers.to(X_w.dtype), iters=refine_iters)
        err = error_fn(T.unsqueeze(-3), (X_w, uv))[..., 0, :]
        inl = err < inlier_threshold_px
        if valid is not None:
            inl = inl & valid
        return PnPResult(T, inl, inl.sum(dim=-1), err)
    return PnPResult(T, res.inliers, res.num_inliers, res.errors)


def _normal_equations(T, X_w, uv, w, K):
    """J^T W J (..., 6, 6) and J^T W r (..., 6) of the reprojection residuals
    under a left se(3) perturbation of T_cw, summed over the points of each
    lane. The two sums run lane by lane: their einsums pick a kernel by the
    batch shape, and a lane must round as its single run. `dist_gn` sums the
    same per-rank terms over the "model" axis."""
    fx, fy, cx, cy = (K[..., i, j, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    eye3 = torch.eye(3, dtype=T.dtype, device=T.device)
    Y = (bmat(T[..., :3, :3], X_w) @ X_w[..., None])[..., 0] + T[..., None, :3, 3]
    z = Y[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
    uv_hat = torch.stack(
        [fx * Y[..., 0] * inv_z + cx, fy * Y[..., 1] * inv_z + cy], dim=-1
    )
    r = uv_hat - uv
    w = w * (z > 1e-6)
    zero = torch.zeros_like(z)
    J_pi = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * Y[..., 0] * inv_z**2], -1),
            torch.stack([zero, fy * inv_z, -fy * Y[..., 1] * inv_z**2], -1),
        ],
        dim=-2,
    )  # (..., N, 2, 3)
    J_xi = torch.cat([eye3.expand(Y.shape[:-1] + (3, 3)), -skew(Y)], dim=-1)
    J = J_pi @ J_xi  # (..., N, 2, 6)
    Jw = J * w[..., None, None]
    H = lane_by_lane(partial(torch.einsum, "...nij,...nik->...jk"), Jw, J, core=3)
    g = lane_by_lane(partial(torch.einsum, "...nij,...ni->...j"), Jw, r, core=3)
    return H, g


def refine_pose_gn(
    T_cw: torch.Tensor,
    X_w: torch.Tensor,
    uv: torch.Tensor,
    K: torch.Tensor,
    weights: torch.Tensor,
    iters: int = 10,
    damping: float = 1e-4,
) -> torch.Tensor:
    """Fixed-iteration Levenberg-damped Gauss-Newton over the se(3) twist
    (LEFT perturbation T <- exp(xi) T); the 6x6 normal equations are solved
    by the hand-written SPD Cholesky (`spd_solve_small`)."""
    eye6 = torch.eye(6, dtype=T_cw.dtype, device=T_cw.device)
    T = T_cw
    for _ in range(iters):
        H, g = _normal_equations(T, X_w, uv, weights, K)
        delta = spd_solve_small(H + damping * eye6, -g, 6)
        delta = torch.where(torch.isfinite(delta).all(dim=-1, keepdim=True), delta, 0.0)
        T = se3_exp(delta) @ T
    return T
