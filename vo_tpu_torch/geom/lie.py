"""Closed-form SO(3)/SE(3)/Sim(3) exponential and logarithm maps — port of
vo_tpu/geom/lie.py. Every function is batched over leading dims.

Twist convention: xi = (v, w) with translation part first, so
se3_exp(xi) = [[exp(skew(w)), V(w) @ v], [0, 1]].
"""

from __future__ import annotations

import torch

from vo_tpu_torch.geom.points import skew, unskew

# Below this angle the Taylor series of the rotation coefficients is used.
_SMALL = 1e-5


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """A = sin(t)/t, B = (1-cos(t))/t^2, C = (1 - A)/t^2, smooth at 0."""
    small = theta_sq < _SMALL**2
    safe_sq = torch.where(small, 1.0, theta_sq)
    safe_t = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_t)) / safe_sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - a) / safe_sq)
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta_sq = (w * w).sum(dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    K = skew(w)
    return _eye3_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle, robust near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_t)
    axis_vec = unskew(R)  # = sin(theta) * axis

    sin_t = torch.sin(theta)
    near_pi = cos_t < -1.0 + 1e-4
    small = theta < _SMALL

    safe_sin = torch.where(small | near_pi, 1.0, sin_t)
    w_generic = axis_vec * (theta / safe_sin)[..., None]
    w_small = axis_vec * (1.0 + theta * theta / 6.0)[..., None]

    # Near pi: axis from the dominant column of R + I.
    S = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col_norms = torch.linalg.vector_norm(S, dim=-2)
    k = torch.argmax(col_norms, dim=-1)
    axis = torch.take_along_dim(S, k[..., None, None], dim=-1)[..., 0]
    axis = axis / torch.clamp(
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
        min=torch.finfo(R.dtype).tiny,
    )
    sign = torch.where((axis * axis_vec).sum(dim=-1) < 0.0, -1.0, 1.0)
    w_pi = axis * (sign * theta)[..., None]

    w = torch.where(near_pi[..., None], w_pi, w_generic)
    return torch.where(small[..., None], w_small, w)


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(w): translation mixer of the SE(3) exp."""
    theta_sq = (w * w).sum(dim=-1)
    _, b, c = _sinc_coeffs(theta_sq)
    K = skew(w)
    return _eye3_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the SO(3) left Jacobian."""
    theta_sq = (w * w).sum(dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    small = theta < _SMALL
    safe_sq = torch.where(small, 1.0, theta_sq)
    half = 0.5 * torch.sqrt(safe_sq)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / safe_sq,
    )
    K = skew(w)
    return _eye3_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist (v, w) -> (..., 4, 4) homogeneous transform."""
    v, w = xi[..., :3], xi[..., 3:]
    H = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    H[..., :3, :3] = so3_exp(w)
    H[..., :3, 3] = (_left_jacobian(w) @ v[..., None])[..., 0]
    H[..., 3, 3] = 1.0
    return H


def se3_log(H: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transform -> (..., 6) twist (v, w)."""
    w = so3_log(H[..., :3, :3])
    v = (_left_jacobian_inv(w) @ H[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)


def pose_inverse(H: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform: [[R,t],[0,1]]^-1 = [[R^T,-R^T t],[0,1]]."""
    Rt = H[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(H)
    out[..., :3, :3] = Rt
    out[..., :3, 3:4] = -Rt @ H[..., :3, 3:4]
    out[..., 3, 3] = 1.0
    return out


# ---------------------------------------------------------------------------
# Sim(3): similarity transforms (sR, t) — monocular loop closure needs the
# scale DoF (scale drift cannot be expressed in SE(3); Strasdat et al.,
# "Scale Drift-Aware Large Scale Monocular SLAM", RSS 2010). Twist order:
# (v, w, lam).
# ---------------------------------------------------------------------------


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices in closed form (cofactors of the
    first row): elementwise work, no LU and no host sync per call."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def sim3_scale(S: torch.Tensor) -> torch.Tensor:
    """Scale s of a similarity [[sR, t], [0, 1]]: det(sR) = s^3."""
    return torch.clamp(det3(S[..., :3, :3]), min=1e-30).pow(1.0 / 3.0)


def _sim3_W(w: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Translation mixer of the Sim(3) exp: W = int_0^1 e^{lam*tau} R(tau*w) dtau.

    Closed form via the scalar integrals (s = e^lam, theta = |w|):
      C  = int e^{lam t}            = (s - 1)/lam
      A' = int e^{lam t} sin(th t)  = (s(lam sin th - th cos th) + th)/(lam^2+th^2)
      B' = int e^{lam t} cos(th t)  = (s(lam cos th + th sin th) - lam)/(lam^2+th^2)
      W  = C I + (A'/th) [w]x + ((C - B')/th^2) [w]x^2
    with series fallbacks where lam and/or theta vanish (at lam=0 this
    reduces exactly to the SE(3) left Jacobian)."""
    theta_sq = (w * w).sum(dim=-1)
    theta = torch.sqrt(torch.where(theta_sq < 1e-12, 1.0, theta_sq))
    s = torch.exp(lam)
    lam_small = lam.abs() < 1e-4
    th_small = theta_sq < 1e-8
    lam_safe = torch.where(lam_small, 1.0, lam)
    denom = lam * lam + theta_sq

    C = torch.where(lam_small, 1.0 + lam / 2.0 + lam * lam / 6.0, (s - 1.0) / lam_safe)
    # alpha = A'/theta ; beta = (C - B')/theta^2
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom_safe = torch.where(th_small & lam_small, 1.0, denom)
    Ap = (s * (lam * sin_t - theta * cos_t) + theta) / denom_safe
    Bp = (s * (lam * cos_t + theta * sin_t) - lam) / denom_safe
    # Small-theta series (lam general): alpha -> D, beta -> E/2 with
    # D = int t e^{lam t} = (s(lam-1)+1)/lam^2, E = int t^2 e^{lam t}.
    D = torch.where(lam_small, 0.5 + lam / 3.0,
                    (s * (lam_safe - 1.0) + 1.0) / (lam_safe * lam_safe))
    E = torch.where(
        lam_small, 1.0 / 3.0 + lam / 4.0,
        (s * (lam_safe * lam_safe - 2.0 * lam_safe + 2.0) - 2.0) / (lam_safe ** 3),
    )
    alpha = torch.where(th_small, D, Ap / theta)
    beta = torch.where(th_small, 0.5 * E, (C - Bp) / torch.where(th_small, 1.0, theta_sq))

    K = skew(w)
    return (C[..., None, None] * _eye3_like(K) + alpha[..., None, None] * K
            + beta[..., None, None] * (K @ K))


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 7) twist (v, w, lam) -> (..., 4, 4) similarity [[e^lam R, Wv],[0,1]]."""
    v, w, lam = xi[..., :3], xi[..., 3:6], xi[..., 6]
    H = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    H[..., :3, :3] = torch.exp(lam)[..., None, None] * so3_exp(w)
    H[..., :3, 3] = (_sim3_W(w, lam) @ v[..., None])[..., 0]
    H[..., 3, 3] = 1.0
    return H


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices by the adjugate (closed form)."""
    c0 = torch.linalg.cross(M[..., 1, :], M[..., 2, :])
    c1 = torch.linalg.cross(M[..., 2, :], M[..., 0, :])
    c2 = torch.linalg.cross(M[..., 0, :], M[..., 1, :])
    adj = torch.stack([c0, c1, c2], dim=-1)
    return adj / (M[..., 0, :] * c0).sum(dim=-1)[..., None, None]


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) similarity -> (..., 7) twist (v, w, lam)."""
    s = sim3_scale(S)
    lam = torch.log(s)
    w = so3_log(S[..., :3, :3] / s[..., None, None])
    v = (_inv3(_sim3_W(w, lam)) @ S[..., :3, 3:4])[..., 0]
    return torch.cat([v, w, lam[..., None]], dim=-1)


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    """[[sR, t],[0,1]]^-1 = [[s^-1 R^T, -s^-1 R^T t],[0,1]]."""
    s = sim3_scale(S)
    Rt = S[..., :3, :3].transpose(-1, -2) / (s * s)[..., None, None]
    out = torch.zeros_like(S)
    out[..., :3, :3] = Rt
    out[..., :3, 3:4] = -Rt @ S[..., :3, 3:4]
    out[..., 3, 3] = 1.0
    return out
