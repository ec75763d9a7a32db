"""Point-coordinate helpers — port of vo_tpu/geom/points.py.

Points are (..., N, D) or (..., D) tensors with the coordinate on the LAST
axis; every function broadcasts over leading batch axes.
"""

from __future__ import annotations

import math

import torch


def lift(M: torch.Tensor, ndim: int) -> torch.Tensor:
    """Insert singleton axes before the last two of a per-lane matrix
    (*lead, r, c) until it has `ndim` dims, so that it broadcasts against
    per-point or per-hypothesis operands (*lead, *mid, ...). A plain 2-D
    matrix (no lane axis) broadcasts as it is and comes back unchanged."""
    if M.ndim == 2 or M.ndim >= ndim:
        return M
    return M.reshape(M.shape[:-2] + (1,) * (ndim - M.ndim) + M.shape[-2:])


def bmat(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`lift` a per-lane matrix against vectors x (*lead, *mid, d): the result
    multiplies `x[..., None]`."""
    return lift(M, x.ndim + 1)


def inverse(M: torch.Tensor) -> torch.Tensor:
    """torch.linalg.inv without its error check: the same LU and the same
    bits (`inv_ex`), but no host sync reading the check, so a CUDA graph can
    hold it. A singular matrix gives non-finite entries instead of raising."""
    return torch.linalg.inv_ex(M).inverse


def device_vector(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A vector of Python numbers in `dtype` (f32 unless asked), written on
    `device` by fills. `torch.tensor(values, device=...)` copies from
    pageable host memory and waits for the copy, which a CUDA graph cannot
    hold; the values are the same roundings."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last axis: (..., D) -> (..., D+1)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def to_cartesian(points: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Divide by the last coordinate: (..., D+1) -> (..., D). A zero last
    coordinate yields inf/nan unless eps > 0 guards it."""
    w = points[..., -1:]
    if eps:
        w = torch.where(w.abs() < eps, torch.where(w < 0, -eps, eps), w)
    return points[..., :-1] / w


def normalize_points(
    points: torch.Tensor, weight: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hartley isotropic normalization: centroid to the origin, mean radius
    sqrt(D). Returns (normalized (..., N, D), T (..., D+1, D+1)) with
    normalized_h = (T @ points_h^T)^T. `weight` (..., N) restricts the
    statistics to weighted rows."""
    d = points.shape[-1]
    if weight is None:
        centroid = points.mean(dim=-2, keepdim=True)
        centered = points - centroid
        mean_dist = torch.linalg.vector_norm(centered, dim=-1).mean(dim=-1)
    else:
        wsum = torch.clamp(weight.sum(dim=-1, keepdim=True), min=1e-12)
        centroid = (points * weight[..., None]).sum(dim=-2, keepdim=True) / wsum[..., None]
        centered = points - centroid
        mean_dist = (
            torch.linalg.vector_norm(centered, dim=-1) * weight
        ).sum(dim=-1) / wsum[..., 0]
    scale = math.sqrt(d) / torch.clamp(mean_dist, min=torch.finfo(points.dtype).tiny)
    normalized = centered * scale[..., None, None]

    T = torch.zeros(points.shape[:-2] + (d + 1, d + 1), dtype=points.dtype,
                    device=points.device)
    diag = torch.arange(d, device=points.device)
    T[..., diag, diag] = scale[..., None]
    T[..., :d, d] = -scale[..., None] * centroid[..., 0, :]
    T[..., d, d] = 1.0
    return normalized, T


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric (cross-product) matrix."""
    zeros = torch.zeros_like(v[..., 0])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )


def unskew(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3): inverse of `skew` (off-diagonal averages)."""
    x = 0.5 * (m[..., 2, 1] - m[..., 1, 2])
    y = 0.5 * (m[..., 0, 2] - m[..., 2, 0])
    z = 0.5 * (m[..., 1, 0] - m[..., 0, 1])
    return torch.stack([x, y, z], dim=-1)
