"""Patch descriptors and batched descriptor matching — port of
vo_tpu/ops/descriptors.py.

Patch extraction is one vectorized gather (plain PyTorch here as it is plain
XLA in the reference: this is not the LK patch-gather kernel); the distance
matrix is one (K1, K2) matrix product at full f32; top-2 selection, ratio
test and mutual uniqueness are mask reductions. All shapes fixed; dead slots
carry +inf distance.

Lanes: every argument may carry leading lane axes, (B, H, W) images with
(B, K, 2) keypoints and (B, K, D) descriptors. The matrix product runs lane
by lane (one `mm` each), so lane b of a batch rounds exactly as the
unbatched call on lane b whatever kernel a batched product would choose.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INF = float("inf")


def extract_patches(
    img: torch.Tensor, xy: torch.Tensor, radius: int = 9, normalize: bool = False
) -> torch.Tensor:
    """(..., K, 2) integer-ish keypoints -> (..., K, (2r+1)^2) raw intensity
    patches of img (..., H, W). Coordinates are rounded (half to even) and
    clamped so border keypoints still yield patches."""
    h, w = img.shape[-2:]
    size = 2 * radius + 1
    k = xy.shape[-2]
    x0 = torch.clamp(torch.round(xy[..., 0]).long(), radius, w - radius - 1)
    y0 = torch.clamp(torch.round(xy[..., 1]).long(), radius, h - radius - 1)
    d = torch.arange(-radius, radius + 1, device=img.device)
    yy = y0[..., None, None] + d[:, None]
    xx = x0[..., None, None] + d[None, :]
    flat = img.reshape(img.shape[:-2] + (h * w,))
    idx = (yy * w + xx).reshape(xy.shape[:-2] + (k * size * size,))
    patches = torch.take_along_dim(flat, idx, dim=-1).reshape(xy.shape[:-2] + (k, size * size))
    if normalize:
        centred = patches - patches.mean(dim=-1, keepdim=True)
        sd = torch.sqrt((centred * centred).mean(dim=-1, keepdim=True))
        patches = centred / torch.clamp(sd, min=1e-6)
    return patches


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (..., K1) int64 index into descriptors2, -1 = no match
    dist: torch.Tensor  # (..., K1) SSD distance of the match (inf where none)
    valid: torch.Tensor  # (..., K1) bool


def _lanewise_abt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K1, D) @ b (..., K2, D)^T -> (..., K1, K2), one `mm` a lane."""
    if a.ndim == 2:
        return a @ b.T
    lead = a.shape[:-2]
    af, bf = a.reshape((-1,) + a.shape[-2:]), b.reshape((-1,) + b.shape[-2:])
    out = torch.stack([x @ y.T for x, y in zip(af, bf)])
    return out.reshape(lead + out.shape[-2:])


def match_descriptors(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    ratio: float = 0.85,
    max_dist: float = _INF,
    mutual: bool = True,
    pair_valid: torch.Tensor | None = None,
) -> MatchResult:
    """Brute-force SSD matching with Lowe ratio test and uniqueness.

    The (K1, K2) squared-distance matrix is ||a||^2 + ||b||^2 - 2 a.b.
    Uniqueness = mutual nearest neighbours. Among equal distances the lower
    index wins, in the top-2 as in the column minimum (`lax.top_k`'s and
    `argmin`'s order: `torch.argmin` returns the first minimum).
    `pair_valid` (K1, K2) is a caller-provided candidate gate applied BEFORE
    the ratio test."""
    n1 = (d1 * d1).sum(dim=-1)
    n2 = (d2 * d2).sum(dim=-1)
    dist = n1[..., :, None] + n2[..., None, :] - 2.0 * _lanewise_abt(d1, d2)
    dist = torch.clamp(dist, min=0.0)
    if valid1 is not None:
        dist = torch.where(valid1[..., :, None], dist, _INF)
    if valid2 is not None:
        dist = torch.where(valid2[..., None, :], dist, _INF)
    if pair_valid is not None:
        dist = torch.where(pair_valid, dist, _INF)

    # Top-2 smallest per row, the lower index first among ties: the first
    # minimum, then the first minimum of the rest.
    best, best_idx = dist.min(dim=-1)
    cols = torch.arange(dist.shape[-1], device=dist.device)
    rest = torch.where(cols == best_idx[..., None], _INF, dist)
    second = rest.min(dim=-1).values
    ok = torch.isfinite(best) & (best <= max_dist)
    # Lowe ratio on L2 distances; the matrix is squared, hence ratio^2.
    ok = ok & (best < (ratio * ratio) * ratio_guard(second))
    if mutual:
        col_best = torch.argmin(dist, dim=-2)  # (..., K2)
        rows = torch.arange(dist.shape[-2], device=dist.device)
        ok = ok & (torch.take_along_dim(col_best, best_idx, dim=-1) == rows)
    return MatchResult(
        idx=torch.where(ok, best_idx, -1),
        dist=torch.where(ok, best, _INF),
        valid=ok,
    )


def ratio_guard(second: torch.Tensor) -> torch.Tensor:
    """Make the ratio test pass when there is no second candidate."""
    return torch.where(torch.isfinite(second), second, _INF)
