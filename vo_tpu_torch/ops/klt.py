"""Pyramidal Lucas-Kanade optical flow, batched over keypoints — port of
vo_tpu/ops/klt.py.

Each keypoint performs ONE contiguous patch load per pyramid level and image;
on the card both loads of a level, for all keypoints of all lanes, are ONE
launch of the K2 patch-gather kernel (ops/kernels.py `extract_patch_pairs`),
which reads the levels as they are: the reference's edge-replicated copies of
each level exist only in the plain version. What follows the gathers — the
template resample and gradients, G, the iterations and the error — is on the
card ONE launch of csrc/lk_solve.cu a level (`kernels.lk_solve`), a warp a
point. Its plain version, `lk_solve_plain` (the CPU path, `use_pallas=False`
and the kernel's oracle), does every bilinear window resample as two small
batched matmuls with tent-function selection matrices:

    window = W_y(p) @ patch @ W_x(p)^T,   W[i, j] = max(0, 1 - |j - (p+i)|)

and turns the reference's `lax.while_loop` early exit into a fixed
`max_iters` loop: converged keypoints add a delta of exactly 0, so the two
agree bit for bit, and the fixed trip count needs no host sync. The kernel
samples the two non-zero taps of each tent and lets a point stop when it
converges, which gives the same iterations; its sums over a window run in
another order, so it agrees with the plain version to a few ulps. The
reference's TPU-only 48/256 over-pad of the levels (aligned DMA regions) is
not carried over.

Every function takes (K, 2) points with (H, W) levels or, with a leading
lane axis, (B, K, 2) points with (B, H, W) levels; lane b of the batched
call is the unbatched call on lane b, and the patch gathers and the solve of
a level of a batch are ONE launch each (K2b, lk_solve_batched).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from vo_tpu_torch.geom.points import device_vector
from vo_tpu_torch.ops.kernels import extract_patch_pairs, lk_solve

# Max |d| within one level before window samples clamp at the patch border.
MARGIN = 8


class TrackResult(NamedTuple):
    xy: torch.Tensor  # (..., K, 2) tracked positions in the next frame
    status: torch.Tensor  # (..., K) bool — converged, well-conditioned, in-bounds
    err: torch.Tensor  # (..., K) mean |I_next - I_prev| over the window


def _sel(pos: torch.Tensor, out_size: int, in_size: int) -> torch.Tensor:
    """(..., K, out_size, in_size) bilinear selection (tent) matrices from
    pos (..., K): row i carries the interpolation weights for input
    coordinate pos + i."""
    i = torch.arange(out_size, dtype=torch.float32, device=pos.device)
    j = torch.arange(in_size, dtype=torch.float32, device=pos.device)
    p = pos[..., None] + i  # (..., K, out)
    return torch.clamp(1.0 - torch.abs(j - p[..., None]), min=0.0)


def _resample(patch: torch.Tensor, pos_xy: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear (out, out) windows from (..., K, P, P) patches at float
    corners pos_xy (..., K, 2) — two batched f32 matmuls (the lane and
    keypoint axes folded into one bmm batch), no gathers."""
    P = patch.shape[-1]
    wy = _sel(pos_xy[..., 1], out_size, P)  # (..., K, out, P)
    wx = _sel(pos_xy[..., 0], out_size, P)
    lead = patch.shape[:-2]
    out = torch.bmm(torch.bmm(wy.flatten(0, -3), patch.flatten(0, -3)),
                    wx.flatten(0, -3).transpose(1, 2))
    return out.reshape(lead + (out_size, out_size))


def _lk_level(
    prev_img: torch.Tensor,
    next_img: torch.Tensor,
    pt_prev: torch.Tensor,  # (..., K, 2) template centers at this level
    guess: torch.Tensor,  # (..., K, 2) flow guess at this level
    radius: int,
    max_iters: int,
    eps: float,
    min_eig_threshold: float,
    use_pallas: bool | None = None,
    actives: list | None = None,
):
    """One pyramid level of Bouguet LK for all keypoints. Returns
    (flow (..., K, 2), conditioned (..., K) bool, err (..., K)). Where a
    list `actives` is given, the solve appends to it each point's count of
    the iterations that moved it (`kernels.lk_solve`)."""
    h, w = prev_img.shape[-2:]
    win = 2 * radius + 1
    # Corners are in the coordinates of the level edge-replicated by `pad`,
    # which keeps every window below inside that extent. The padded levels
    # themselves are built only by the plain version of the gather.
    pad = radius + MARGIN + 2
    zero = torch.zeros(2, dtype=torch.float32, device=pt_prev.device)
    bound = device_vector((w - 1.0, h - 1.0), pt_prev.device)

    # ---- Both patch loads of the level: the template around pt_prev in the
    # previous image, the search patch around pt_prev + guess in the next ---
    tp_size = win + 4
    pt_c = torch.clamp(pt_prev, zero, bound)
    base = torch.floor(pt_c)
    tcorner = base.to(torch.int32) - radius - 2 + pad
    sp_size = win + 2 * MARGIN + 2
    center0 = torch.clamp(pt_prev + guess, zero, bound)
    scorner = torch.floor(center0).to(torch.int32) - radius - MARGIN + pad
    tpatch, spatch = extract_patch_pairs(
        prev_img, next_img, tcorner, scorner, tp_size, sp_size, pad, use_kernel=use_pallas)
    # What the solve needs of the corners: the template's sub-pixel offset
    # and the search window's origin inside its patch before any update.
    tfrac = pt_c - base
    s_base = (center0 - radius) + pad - scorner.to(torch.float32)
    return lk_solve(tpatch, spatch, tfrac, s_base, guess, radius, max_iters, eps,
                    min_eig_threshold, actives, use_kernel=use_pallas)


def lk_solve_plain(
    tpatch: torch.Tensor,  # (..., K, win+4, win+4) templates around pt_prev
    spatch: torch.Tensor,  # (..., K, S, S) search patches around pt_prev + guess
    tfrac: torch.Tensor,  # (..., K, 2) the template centres' sub-pixel offsets
    s_base: torch.Tensor,  # (..., K, 2) the search windows' origins in their patches
    guess: torch.Tensor,  # (..., K, 2) flow guess at this level
    radius: int,
    max_iters: int,
    eps: float,
    min_eig_threshold: float,
    actives: list | None = None,
):
    """The solve of one level from its patch pair, in plain PyTorch: the CPU
    path and the oracle of csrc/lk_solve.cu (`kernels.lk_solve`). Returns
    (guess + d, conditioned, err); where a list `actives` is given, appends
    to it the (..., K) int32 count, per point, of the iterations that moved
    it (its `active` masks summed)."""
    win = 2 * radius + 1
    sp_size = spatch.shape[-1]

    # ---- Template + gradients: one (win+2) resample ------------------------
    T_ext = _resample(tpatch, tfrac + 1.0, win + 2)  # (..., K, win+2, win+2)
    T = T_ext[..., 1:-1, 1:-1]
    Ix = 0.5 * (T_ext[..., 1:-1, 2:] - T_ext[..., 1:-1, :-2])
    Iy = 0.5 * (T_ext[..., 2:, 1:-1] - T_ext[..., :-2, 1:-1])

    gxx = (Ix * Ix).sum(dim=(-2, -1))
    gxy = (Ix * Iy).sum(dim=(-2, -1))
    gyy = (Iy * Iy).sum(dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    dg = gxx - gyy
    min_eig = 0.5 * (gxx + gyy) - torch.sqrt(
        torch.clamp(0.25 * (dg * dg) + gxy * gxy, min=0.0)
    )
    conditioned = (min_eig / (win * win) > min_eig_threshold) & (det.abs() > 1e-8)
    inv_det = torch.where(det.abs() > 1e-8, 1.0 / det, 0.0)

    # ---- Search window positions inside the search patch ------------------
    pos_hi = float(sp_size - win - 1) - 1e-4

    def sample_next(pos):  # pos (..., K, 2) -> (..., K, win, win)
        return _resample(spatch, torch.clamp(pos, 0.0, pos_hi), win)

    d = torch.zeros_like(tfrac)
    active = conditioned
    masks = []
    for _ in range(max_iters):
        masks.append(active)
        diff = T - sample_next(s_base + d)
        bx = (diff * Ix).sum(dim=(-2, -1))
        by = (diff * Iy).sum(dim=(-2, -1))
        # Solve G delta = b with the cached 2x2 inverse.
        dx = inv_det * (gyy * bx - gxy * by)
        dy = inv_det * (-gxy * bx + gxx * by)
        delta = torch.where(active[..., None], torch.stack([dx, dy], dim=-1), 0.0)
        d = d + delta
        active = active & ((delta * delta).sum(dim=-1) > eps * eps)

    err = torch.abs(sample_next(s_base + d) - T).mean(dim=(-2, -1))
    if actives is not None:
        actives.append(torch.stack(masks).sum(0, dtype=torch.int32))
    return guess + d, conditioned, err


def pyramidal_lk(
    prev_pyr: Sequence[torch.Tensor],
    next_pyr: Sequence[torch.Tensor],
    xy: torch.Tensor,
    radius: int = 8,
    max_iters: int = 10,
    eps: float = 0.03,
    max_err: float = 25.0,
    min_eig_threshold: float = 1e-4,
    use_pallas: bool | None = None,
    init_flow: torch.Tensor | None = None,
) -> TrackResult:
    """Track keypoints xy (K, 2) from prev to next frame across a Gaussian
    pyramid (level 0 = full res), or (B, K, 2) keypoints across (B, H, W)
    levels. `init_flow`, shaped as xy, seeds the level-0 flow
    (motion-model prediction); non-finite or absurd guesses fall back to 0.
    `use_pallas` routes the patch gathers and the solve: None = by device,
    False = plain."""
    return pyramidal_lk_counted(prev_pyr, next_pyr, xy, radius, max_iters, eps, max_err,
                                min_eig_threshold, use_pallas, init_flow, count=False)[0]


def pyramidal_lk_counted(
    prev_pyr: Sequence[torch.Tensor],
    next_pyr: Sequence[torch.Tensor],
    xy: torch.Tensor,
    radius: int = 8,
    max_iters: int = 10,
    eps: float = 0.03,
    max_err: float = 25.0,
    min_eig_threshold: float = 1e-4,
    use_pallas: bool | None = None,
    init_flow: torch.Tensor | None = None,
    count: bool = True,
) -> tuple[TrackResult, torch.Tensor | None]:
    """`pyramidal_lk` and, with `count`, the point-iterations still active,
    whose update the solver applies (its `active` mask, summed over
    iterations, levels and points; per lane with a lane axis), else None. The
    levels' solves each append a count a point, summed once after every
    level; the track itself is `pyramidal_lk`'s bit for bit."""
    levels = len(prev_pyr)
    if init_flow is None:
        flow = torch.zeros_like(xy)
    else:
        h0, w0 = prev_pyr[0].shape[-2:]
        sane = (
            torch.isfinite(init_flow).all(dim=-1)
            & (init_flow[..., 0].abs() < 0.5 * w0)
            & (init_flow[..., 1].abs() < 0.5 * h0)
        )
        flow = torch.where(sane[..., None], init_flow, 0.0) / (2.0 ** (levels - 1))
    conditioned = torch.ones(xy.shape[:-1], dtype=torch.bool, device=xy.device)
    err = torch.zeros(xy.shape[:-1], dtype=torch.float32, device=xy.device)
    actives = [] if count else None
    for lvl in range(levels - 1, -1, -1):
        scale = 2.0**lvl
        flow, cond_l, err = _lk_level(
            prev_pyr[lvl], next_pyr[lvl], xy / scale, flow,
            radius, max_iters, eps, min_eig_threshold, use_pallas, actives,
        )
        if lvl > 0:
            flow = flow * 2.0
        conditioned = conditioned & cond_l
    new_xy = xy + flow
    h, w = prev_pyr[0].shape[-2:]
    in_bounds = (
        (new_xy[..., 0] >= radius)
        & (new_xy[..., 0] < w - radius)
        & (new_xy[..., 1] >= radius)
        & (new_xy[..., 1] < h - radius)
    )
    status = conditioned & in_bounds & (err < max_err)
    active = torch.stack(actives).sum(dim=(0, -1)) if actives else None
    return TrackResult(xy=new_xy, status=status, err=err), active
