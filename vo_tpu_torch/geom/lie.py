"""Closed-form SO(3)/SE(3) exponential and logarithm maps — port of
vo_tpu/geom/lie.py (the Sim(3) half waits for the loop-closure back-end).

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
