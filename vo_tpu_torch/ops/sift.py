"""SIFT-style multi-scale front-end: DoG pyramid detection, orientation
assignment, and 128-D gradient-histogram descriptors — port of
vo_tpu/ops/sift.py. No per-keypoint loops anywhere:

  * the Gaussian/DoG scale-space is a static set of separable blurs (shifted
    adds, ops/image.py), shapes halve per octave;
  * scale-space extrema = two 3x3 window passes (spatial max/min) plus
    cross-scale comparisons, with contrast + edge-ratio (Hessian) rejection;
  * per-octave top-K selection by a stable sort (fixed slot counts, validity
    masks; among equal scores the lower index first);
  * orientation + descriptor run for all keypoints at once over fixed 13x13
    and 16x16 sample grids, soft orientation binning, Lowe
    normalize-clip-renormalize. The histograms are one-hot products summed
    in a fixed order (no scatter-add: on a GPU that would be atomics, and a
    seeded run would stop reproducing).

Differences from canonical SIFT, as in the reference: no 2x input upsampling
(the -1 octave), hard spatial cell assignment, quadratic subpixel refinement
in position only. The DoG Hessians use `torch.roll`, which wraps at the
border exactly as the reference's `jnp.roll` does (the border mask drops
those pixels).

Lanes: every function takes (H, W) images or (B, H, W) with keypoint arrays
(B, K, ...); lane b of a batched call is the unbatched call on lane b.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vo_tpu_torch.ops.harris import top_k
from vo_tpu_torch.ops.image import gaussian_blur, image_gradients

_BASE_SIGMA = 1.6
_INF = float("inf")


class SiftKeypoints(NamedTuple):
    xy: torch.Tensor  # (K, 2) level-0 pixel coordinates
    sigma: torch.Tensor  # (K,) absolute scale in level-0 pixels
    octave: torch.Tensor  # (K,) int32 octave index
    score: torch.Tensor  # (K,) |DoG| response
    valid: torch.Tensor  # (K,) bool


def _octave_sigmas(scales_per_octave: int) -> list[float]:
    """Absolute blur of each image in one octave's Gaussian stack."""
    return [
        _BASE_SIGMA * (2.0 ** (s / scales_per_octave))
        for s in range(scales_per_octave + 3)
    ]


def _build_octave(base: torch.Tensor, scales_per_octave: int) -> torch.Tensor:
    """(..., S+3, H, W) Gaussian stack; base is assumed blurred to _BASE_SIGMA."""
    sigmas = _octave_sigmas(scales_per_octave)
    imgs = [base]
    for i in range(1, len(sigmas)):
        inc = math.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-6))
        imgs.append(gaussian_blur(imgs[-1], inc))
    return torch.stack(imgs, dim=-3)


def build_scale_space(
    img: torch.Tensor, num_octaves: int, scales_per_octave: int
) -> list[torch.Tensor]:
    """List of per-octave Gaussian stacks [(..., S+3, H_o, W_o)], halving sizes."""
    base = gaussian_blur(img.to(torch.float32), _BASE_SIGMA)
    octaves = []
    for _ in range(num_octaves):
        stack = _build_octave(base, scales_per_octave)
        octaves.append(stack)
        # Next octave seeds from the image with blur 2*_BASE_SIGMA.
        base = stack[..., scales_per_octave, ::2, ::2].contiguous()
    return octaves


def _pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 window max over the last two dims, -inf outside the image."""
    h, w = x.shape[-2:]
    return F.max_pool2d(x.reshape(-1, 1, h, w), 3, stride=1, padding=1).reshape(x.shape)


def _dog_derivatives(c: torch.Tensor):
    """Central differences of the centre DoG scales (..., S, H, W), wrapping
    at the border: (gx, gy, dxx, dyy, dxy)."""
    xp, xm = torch.roll(c, -1, dims=-1), torch.roll(c, 1, dims=-1)
    yp, ym = torch.roll(c, -1, dims=-2), torch.roll(c, 1, dims=-2)
    dxx = xp + xm - 2 * c
    dyy = yp + ym - 2 * c
    dxy = 0.25 * (
        torch.roll(yp, -1, dims=-1)
        + torch.roll(ym, 1, dims=-1)
        - torch.roll(yp, 1, dims=-1)
        - torch.roll(ym, -1, dims=-1)
    )
    return 0.5 * (xp - xm), 0.5 * (yp - ym), dxx, dyy, dxy


def _extrema_mask(dog: torch.Tensor, contrast_threshold: float, edge_ratio: float):
    """(..., S+2, H, W) DoG stack -> per middle scale s in [1, S]:
    is_extremum mask + |response|. Returns (..., S, H, W) masks and scores."""
    nearby_max = _pool3(dog)
    nearby_min = -_pool3(-dog)
    c = dog[..., 1:-1, :, :]  # center scales
    # Strict max/min vs the 26 neighbours: the same-scale window max (the
    # centre included) and the 3x3 window max of the scales above and below.
    up_max, dn_max = nearby_max[..., 2:, :, :], nearby_max[..., :-2, :, :]
    up_min, dn_min = nearby_min[..., 2:, :, :], nearby_min[..., :-2, :, :]
    same_max = nearby_max[..., 1:-1, :, :]
    same_min = nearby_min[..., 1:-1, :, :]
    is_max = (c >= same_max) & (c > up_max) & (c > dn_max)
    is_min = (c <= same_min) & (c < up_min) & (c < dn_min)
    contrast = c.abs() > contrast_threshold

    # Edge rejection: 2x2 spatial Hessian ratio (Lowe 4.1).
    _, _, dxx, dyy, dxy = _dog_derivatives(c)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    not_edge = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    return (is_max | is_min) & contrast & not_edge, c.abs()


def sift_detect(
    img: torch.Tensor,
    num_keypoints: int,
    num_octaves: int = 3,
    scales_per_octave: int = 3,
    contrast_threshold: float = 0.02,
    edge_ratio: float = 10.0,
    border: int = 8,
    octaves: list[torch.Tensor] | None = None,
) -> SiftKeypoints:
    """Detect up to `num_keypoints` DoG extrema across octaves (fixed slots).

    `contrast_threshold` is relative to a [0, 1] intensity range; images in
    [0, 255] are normalized internally. Slots are filled per octave
    (num_keypoints // num_octaves each, remainder to octave 0) so coarse
    scales are guaranteed representation, then packed strongest-first.
    `octaves` takes the scale space of img / 255 where the caller has built
    it already (`build_scale_space`)."""
    if octaves is None:
        octaves = build_scale_space(img.to(torch.float32) / 255.0, num_octaves,
                                    scales_per_octave)
    lead = img.shape[:-2]
    dev = img.device

    per_oct = [num_keypoints // num_octaves] * num_octaves
    per_oct[0] += num_keypoints - sum(per_oct)

    xs, ys, sg, oc, sc, va = [], [], [], [], [], []
    for o, stack in enumerate(octaves):
        dog = stack[..., 1:, :, :] - stack[..., :-1, :, :]  # (..., S+2, H, W)
        mask, score = _extrema_mask(dog, contrast_threshold, edge_ratio)
        h, w = mask.shape[-2:]
        if border > 0:
            bm = torch.zeros((h, w), dtype=torch.bool, device=dev)
            bm[border:-border, border:-border] = True
            mask = mask & bm
        flat = torch.where(mask, score, -_INF).flatten(-3)
        k_o = per_oct[o]
        top, idx = top_k(flat, k_o)
        valid = torch.isfinite(top)
        sidx = idx // (h * w)
        rem = idx % (h * w)
        yy = (rem // w).to(torch.float32)
        xx = (rem % w).to(torch.float32)

        # Quadratic spatial subpixel refinement (Lowe 4): offset = -H^{-1} g
        # of the DoG surface at the extremum, clamped. Without it the
        # keypoint sits on the OCTAVE grid (+-0.5 * 2^o level-0 pixels), and
        # matched detections ARE the tracked positions feeding PnP.
        c = dog[..., 1:-1, :, :]
        gx, gy, hxx, hyy, hxy = (
            t.flatten(-3).gather(-1, idx) for t in _dog_derivatives(c))
        det = hxx * hyy - hxy * hxy
        safe_det = torch.where(det.abs() > 1e-12, det, 1.0)
        ox = -(hyy * gx - hxy * gy) / safe_det
        oy = -(-hxy * gx + hxx * gy) / safe_det
        ok_off = (det.abs() > 1e-12) & (ox.abs() <= 1.0) & (oy.abs() <= 1.0)
        ox = torch.where(ok_off, torch.clamp(ox, -0.5, 0.5), 0.0)
        oy = torch.where(ok_off, torch.clamp(oy, -0.5, 0.5), 0.0)

        scale_in_oct = _BASE_SIGMA * (
            2.0 ** ((sidx.to(torch.float32) + 1.0) / scales_per_octave))
        mul = float(2**o)
        xs.append((xx + ox) * mul)
        ys.append((yy + oy) * mul)
        sg.append(scale_in_oct * mul)
        oc.append(torch.full(lead + (k_o,), o, dtype=torch.int32, device=dev))
        sc.append(torch.where(valid, top, 0.0))
        va.append(valid)

    xy = torch.stack([torch.cat(xs, dim=-1), torch.cat(ys, dim=-1)], dim=-1)
    sigma, octave, score, valid = (torch.cat(t, dim=-1) for t in (sg, oc, sc, va))
    # Pack strongest first across octaves (stable under the validity mask).
    order = torch.argsort(-torch.where(valid, score, -_INF), dim=-1, stable=True)
    return SiftKeypoints(
        xy=torch.take_along_dim(xy, order[..., None], dim=-2),
        sigma=sigma.gather(-1, order),
        octave=octave.gather(-1, order),
        score=score.gather(-1, order),
        valid=valid.gather(-1, order),
    )


def _sample_slices(stack: torch.Tensor, s_idx: torch.Tensor, pts: torch.Tensor):
    """Bilinear samples of one slice per keypoint: stack (L, S, H, W), s_idx
    (L, K) slice of each keypoint, pts (L, K, n, 2) float (x, y) -> (L, K, n).
    Coordinates are clamped to the image, as ops/image.py `bilinear_sample`."""
    n_l, _, h, w = stack.shape
    x = torch.clamp(pts[..., 0], 0.0, w - 1.000001)
    y = torch.clamp(pts[..., 1], 0.0, h - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    flat = stack.reshape(n_l, -1)
    base = (s_idx.long() * (h * w))[..., None]

    def at(yy, xx):
        idx = (base + yy * w + xx).reshape(n_l, -1)
        return torch.gather(flat, -1, idx).reshape(x.shape)

    v00 = at(y0, x0)
    v01 = at(y0, x1)
    v10 = at(y1, x0)
    v11 = at(y1, x1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _descriptor_at(
    gxs: torch.Tensor,  # (L, S+3, H, W) x-gradients of one octave's stack
    gys: torch.Tensor,
    s_rel: torch.Tensor,  # (L, K) stack slice of each keypoint
    xy_oct: torch.Tensor,  # (L, K, 2) keypoint positions at octave resolution
    sigma_oct: torch.Tensor,  # (L, K) scales at octave resolution
) -> torch.Tensor:
    """(L, K, 128) descriptors of all keypoints on one octave."""
    dev = xy_oct.device
    two_pi = 2 * math.pi
    delta = (0.75 * sigma_oct)[..., None, None]  # (L, K, 1, 1)
    centre = xy_oct[..., None, :]  # (L, K, 1, 2)

    # --- Orientation: 36-bin gradient histogram on a 13x13 grid -----------
    r = torch.arange(-6.0, 7.0, device=dev)
    dy, dx = (t.reshape(-1) for t in torch.meshgrid(r, r, indexing="ij"))
    grid = centre + torch.stack([dx, dy], dim=-1) * delta  # (L, K, 169, 2)
    px = _sample_slices(gxs, s_rel, grid)
    py = _sample_slices(gys, s_rel, grid)
    mag = torch.sqrt(px * px + py * py)
    ang = torch.atan2(py, px)  # [-pi, pi]
    wgt = torch.exp(-(dx * dx + dy * dy) / (2.0 * 4.5**2))
    bins = torch.floor((ang + math.pi) / two_pi * 36.0).to(torch.int64) % 36
    hist = (F.one_hot(bins, 36) * (mag * wgt)[..., None]).sum(dim=-2)  # (L, K, 36)
    # Smooth the circular histogram and take the dominant direction.
    hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    theta = (torch.argmax(hist, dim=-1).to(torch.float32) + 0.5) / 36.0 * 2 * math.pi - math.pi

    # --- Descriptor: 16x16 samples -> 4x4 cells x 8 orientation bins ------
    r16 = torch.arange(-7.5, 8.0, device=dev)  # 16 samples
    dy16, dx16 = (t.reshape(-1) for t in torch.meshgrid(r16, r16, indexing="ij"))
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    rx = ct * dx16 - st * dy16
    ry = st * dx16 + ct * dy16
    grid16 = centre + torch.stack([rx, ry], dim=-1) * delta  # rotated, scaled
    sx = _sample_slices(gxs, s_rel, grid16)
    sy = _sample_slices(gys, s_rel, grid16)
    smag = torch.sqrt(sx * sx + sy * sy)
    sang = torch.atan2(sy, sx) - theta[..., None]
    w16 = torch.exp(-(dx16 * dx16 + dy16 * dy16) / (2.0 * 8.0**2))
    m = smag * w16

    # Soft orientation binning into 8 bins, hard 4x4 spatial cells. The cell
    # of a sample is fixed by its place in the grid (rows of 16: cell row =
    # row // 4, cell column = column // 4), so the 128 sums are a reshape
    # and one sum over the 4x4 samples of each cell.
    a = torch.remainder(sang / two_pi, 1.0) * 8.0  # [0, 8)
    b0 = torch.floor(a)
    fb = a - b0
    b0 = b0.to(torch.int64) % 8
    b1 = (b0 + 1) % 8
    votes = (F.one_hot(b0, 8) * (m * (1 - fb))[..., None]
             + F.one_hot(b1, 8) * (m * fb)[..., None])  # (L, K, 256, 8)
    lk = votes.shape[:2]
    desc = votes.reshape(lk + (4, 4, 4, 4, 8)).sum(dim=(3, 5)).reshape(lk + (128,))
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    desc = torch.clamp(desc, max=0.2)
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)


def sift_describe(
    img: torch.Tensor,
    xy: torch.Tensor,  # (K, 2) level-0 pixels
    sigma: torch.Tensor,  # (K,) absolute scale (level-0 px); <=0 -> base scale
    num_octaves: int = 3,
    scales_per_octave: int = 3,
    octaves: list[torch.Tensor] | None = None,
) -> torch.Tensor:
    """(K, 128) descriptors at given positions/scales.

    Each keypoint is assigned the octave whose resolution matches its scale;
    descriptors are computed on every octave and selected by mask (the
    octave count is small and static)."""
    if octaves is None:
        octaves = build_scale_space(img.to(torch.float32) / 255.0, num_octaves,
                                    scales_per_octave)
    lead = img.shape[:-2]
    k = xy.shape[-2]
    xy_l = xy.reshape(-1, k, 2).to(torch.float32)
    sigma = sigma.reshape(-1, k)
    sigma = torch.where(sigma > 0, sigma, _BASE_SIGMA)
    oct_idx = torch.clamp(
        torch.floor(torch.log2(torch.clamp(sigma / _BASE_SIGMA, min=1e-6))).to(torch.int32),
        0,
        num_octaves - 1,
    )
    out = None
    for o, stack in enumerate(octaves):
        # Per-keypoint in-octave Gaussian image: pick the closest scale slice.
        mul = float(2**o)
        sig_oct = sigma / mul
        s_rel = torch.clamp(
            torch.round(
                torch.log2(torch.clamp(sig_oct / _BASE_SIGMA, min=1e-6)) * scales_per_octave
            ).to(torch.int32),
            0,
            scales_per_octave + 2,
        )
        gxs, gys = image_gradients(stack.reshape((-1,) + stack.shape[-3:]))
        desc = _descriptor_at(gxs, gys, s_rel, xy_l / mul, sig_oct)
        out = desc if out is None else torch.where((oct_idx == o)[..., None], desc, out)
    return out.reshape(lead + (k, 128))


def sift_features(
    img: torch.Tensor,
    num_keypoints: int,
    num_octaves: int = 3,
    scales_per_octave: int = 3,
    contrast_threshold: float = 0.02,
    edge_ratio: float = 10.0,
    border: int = 8,
) -> tuple[SiftKeypoints, torch.Tensor]:
    """Detect + describe: (SiftKeypoints, (K, 128) descriptors)."""
    octaves = build_scale_space(img.to(torch.float32) / 255.0, num_octaves,
                                scales_per_octave)
    kp = sift_detect(
        img, num_keypoints, num_octaves, scales_per_octave,
        contrast_threshold, edge_ratio, border, octaves=octaves,
    )
    desc = sift_describe(img, kp.xy, kp.sigma, num_octaves, scales_per_octave,
                         octaves=octaves)
    return kp, desc
