"""The plain reference the benchmark judges the program's answers by. It
imports nothing of the program and takes nothing the program made: the
frames and the ground truth come from the benchmark's own city
(vobench/scene.py), and the arithmetic below is a frozen copy.

- `corner_response`: the Shi-Tomasi response of K1 (the port's
  ops/image.py `sobel`, `box_filter` and ops/harris.py
  `shi_tomasi_response`: Sobel with SAME zero padding, a 7x7 box sum of the
  gradient products, the smaller eigenvalue clamped at 0), in any dtype.
- `window_max`: the (2r+1)^2 running maximum that K1's non-maximum
  suppression keeps a corner by (ops/harris.py `_window_max`).
- `build_pyramid`, `flow_guess`, `pyramidal_lk`: the front end's tracking
  of one frame (ops/image.py's Gaussian pyramid, the constant-velocity
  guess of models/pipeline.py `vo_step`, ops/klt.py's pyramidal
  Lucas-Kanade with its patch gathers done as plain indexing into the
  edge-replicated levels, which the K2 kernel does in one launch a level),
  in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _filt1d(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """1-D correlation along `axis` (0 = rows, 1 = columns of the last two
    dims) with static taps, SAME zero padding, as shifted adds in tap order."""
    r = len(taps) // 2
    dim = img.ndim - 2 + axis
    pad = [0, 0, 0, 0]
    pad[2 * (1 - axis)] = r
    pad[2 * (1 - axis) + 1] = r
    p = F.pad(img, pad)
    n = img.shape[dim]
    out = None
    for i, t in enumerate(taps):
        if t == 0.0:
            continue
        term = t * p.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def corner_response(img: torch.Tensor, patch_size: int = 7,
                    dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Shi-Tomasi response of (..., H, W) grey levels, computed in `dtype`."""
    img = img.to(dtype)
    gx = _filt1d(_filt1d(img, (1.0, 2.0, 1.0), 0), (-1.0, 0.0, 1.0), 1)
    gy = _filt1d(_filt1d(img, (1.0, 2.0, 1.0), 1), (-1.0, 0.0, 1.0), 0)
    ones = (1.0,) * patch_size

    def box(x):
        return _filt1d(_filt1d(x, ones, 0), ones, 1)

    sxx, syy, sxy = box(gx * gx), box(gy * gy), box(gx * gy)
    half_tr = 0.5 * (sxx + syy)
    d = sxx - syy
    rad = torch.sqrt(torch.clamp(0.25 * (d * d) + sxy * sxy, min=0.0))
    return torch.clamp(half_tr - rad, min=0.0)


def window_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 running max over the last two dims of (H, W), -inf outside."""
    return F.max_pool2d(x[None, None], 2 * radius + 1, stride=1, padding=radius)[0, 0]


# ---------------------------------------------------------------------------
# The front end's tracking of one frame
# ---------------------------------------------------------------------------

def _blur(img: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    """Separable Gaussian blur (taps normalised in float64), SAME zero
    padding, columns then rows."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    taps = [float(v) for v in k]
    return _filt1d(_filt1d(img, taps, 1), taps, 0)


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Gaussian pyramid of (H, W) grey levels, level 0 the image: each
    level the last blurred (sigma 1, radius 2) and taken every 2nd pixel."""
    pyr = [img.to(torch.float64)]
    for _ in range(levels - 1):
        pyr.append(_blur(pyr[-1], 1.0, 2)[..., ::2, ::2].contiguous())
    return pyr


def flow_guess(xy: torch.Tensor, state: torch.Tensor, landmark: torch.Tensor,
               pose: torch.Tensor, prev_pose: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """The level-0 flow that seeds tracking (K, 2) slots: the camera moves
    again as it moved from prev_pose to pose (camera-to-world); a slot with
    a landmark (state 2) in front of the predicted camera goes where the
    landmark projects, any other where the rotation alone takes its ray.
    An undistorted camera."""
    def inv(T):
        R, t = T[:3, :3], T[:3, 3]
        out = torch.eye(4, dtype=T.dtype, device=T.device)
        out[:3, :3] = R.T
        out[:3, 3] = -R.T @ t
        return out

    pred = pose @ (inv(prev_pose) @ pose)
    T_pp = inv(pred) @ pose
    h = torch.cat([xy, torch.ones_like(xy[:, :1])], -1)
    uv = (h @ torch.linalg.inv(K).T) @ T_pp[:3, :3].T @ K.T
    uv_rot = uv[:, :2] / torch.where(uv[:, 2:].abs() > 1e-6, uv[:, 2:], 1.0)
    T_cp = inv(pred)
    Xc = landmark @ T_cp[:3, :3].T + T_cp[:3, 3]
    uv = Xc @ K.T
    uv_full = uv[:, :2] / torch.where(Xc[:, 2:] > 0.2, Xc[:, 2:], 1.0)
    full = (state == 2) & (Xc[:, 2] > 0.2)
    return torch.where(full[:, None], uv_full, uv_rot) - xy


def _gather(level: torch.Tensor, corner: torch.Tensor, size: int, pad: int) -> torch.Tensor:
    """(K, size, size) windows of the level edge-replicated by `pad`, at
    integer (x, y) corners of the padded level (each start clamped so the
    window fits)."""
    padded = F.pad(level[None, None], (pad,) * 4, mode="replicate")[0, 0]
    h, w = padded.shape
    x0 = corner[:, 0].clamp(0, w - size)
    y0 = corner[:, 1].clamp(0, h - size)
    ar = torch.arange(size, device=level.device)
    return padded[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]


def _sel(pos: torch.Tensor, out_size: int, in_size: int) -> torch.Tensor:
    i = torch.arange(out_size, dtype=pos.dtype, device=pos.device)
    j = torch.arange(in_size, dtype=pos.dtype, device=pos.device)
    p = pos[..., None] + i
    return torch.clamp(1.0 - torch.abs(j - p[..., None]), min=0.0)


def _resample(patch: torch.Tensor, pos_xy: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear (out, out) windows of (K, P, P) patches at corners (K, 2)."""
    P = patch.shape[-1]
    return _sel(pos_xy[:, 1], out_size, P) @ patch @ _sel(pos_xy[:, 0], out_size,
                                                           P).transpose(1, 2)


def _lk_level(prev, nxt, pt, guess, radius, iters, eps, min_eig_threshold, margin=8):
    h, w = prev.shape
    win = 2 * radius + 1
    pad = radius + margin + 2
    lo = torch.zeros(2, dtype=pt.dtype, device=pt.device)
    hi = torch.tensor([w - 1.0, h - 1.0], dtype=pt.dtype, device=pt.device)
    pt_c = torch.maximum(torch.minimum(pt, hi), lo)
    base = torch.floor(pt_c)
    tpatch = _gather(prev, base.long() - radius - 2 + pad, win + 4, pad)
    sp_size = win + 2 * margin + 2
    center0 = torch.maximum(torch.minimum(pt + guess, hi), lo)
    scorner = torch.floor(center0).long() - radius - margin + pad
    spatch = _gather(nxt, scorner, sp_size, pad)
    T_ext = _resample(tpatch, pt_c - base + 1.0, win + 2)
    T = T_ext[:, 1:-1, 1:-1]
    Ix = 0.5 * (T_ext[:, 1:-1, 2:] - T_ext[:, 1:-1, :-2])
    Iy = 0.5 * (T_ext[:, 2:, 1:-1] - T_ext[:, :-2, 1:-1])
    gxx, gxy, gyy = (Ix * Ix).sum((-2, -1)), (Ix * Iy).sum((-2, -1)), (Iy * Iy).sum((-2, -1))
    det = gxx * gyy - gxy * gxy
    dg = gxx - gyy
    min_eig = 0.5 * (gxx + gyy) - torch.sqrt(torch.clamp(0.25 * dg * dg + gxy * gxy, min=0.0))
    conditioned = (min_eig / (win * win) > min_eig_threshold) & (det.abs() > 1e-8)
    inv_det = torch.where(det.abs() > 1e-8, 1.0 / det, 0.0)
    s_base = (center0 - radius) + pad - scorner.to(pt.dtype)
    pos_hi = float(sp_size - win - 1) - 1e-4

    def sample(pos):
        return _resample(spatch, torch.clamp(pos, 0.0, pos_hi), win)

    d = torch.zeros_like(pt)
    active = conditioned
    for _ in range(iters):
        diff = T - sample(s_base + d)
        bx, by = (diff * Ix).sum((-2, -1)), (diff * Iy).sum((-2, -1))
        step = torch.stack([inv_det * (gyy * bx - gxy * by), inv_det * (-gxy * bx + gxx * by)],
                           -1)
        delta = torch.where(active[:, None], step, 0.0)
        d = d + delta
        active = active & ((delta * delta).sum(-1) > eps * eps)
    err = torch.abs(sample(s_base + d) - T).mean((-2, -1))
    return guess + d, conditioned, err


def pyramidal_lk(prev_pyr, next_pyr, xy: torch.Tensor, init_flow: torch.Tensor, radius: int,
                 max_iters: int, eps: float, max_err: float,
                 min_eig_threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(tracked positions (K, 2), status (K,)) of (K, 2) points from the
    previous frame's pyramid to the next's, seeded by `init_flow` (a guess
    that is not finite or moves over half the image counts as none)."""
    levels = len(prev_pyr)
    h0, w0 = prev_pyr[0].shape
    xy = xy.to(torch.float64)
    init_flow = init_flow.to(torch.float64)
    sane = (torch.isfinite(init_flow).all(-1) & (init_flow[:, 0].abs() < 0.5 * w0)
            & (init_flow[:, 1].abs() < 0.5 * h0))
    flow = torch.where(sane[:, None], init_flow, 0.0) / (2.0 ** (levels - 1))
    conditioned = torch.ones(len(xy), dtype=torch.bool, device=xy.device)
    err = torch.zeros(len(xy), dtype=xy.dtype, device=xy.device)
    for lvl in range(levels - 1, -1, -1):
        flow, cond, err = _lk_level(prev_pyr[lvl], next_pyr[lvl], xy / 2.0 ** lvl, flow,
                                    radius, max_iters, eps, min_eig_threshold)
        if lvl > 0:
            flow = flow * 2.0
        conditioned = conditioned & cond
    new = xy + flow
    inside = ((new[:, 0] >= radius) & (new[:, 0] < w0 - radius) & (new[:, 1] >= radius)
              & (new[:, 1] < h0 - radius))
    return new, conditioned & inside & (err < max_err)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 and back (the control's precision)."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).to(
        torch.float64).numpy()
