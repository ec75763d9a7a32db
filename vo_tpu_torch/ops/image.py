"""Image primitives: grayscale, Sobel, box and Gaussian filters, pyramids,
central-difference gradients, bilinear sampling — port of vo_tpu/ops/image.py.

Images are f32 (H, W) single-channel, or (B, H, W) with a leading lane
axis: every stencil acts on the last two axes, so lane b of a batched call
is the unbatched call on lane b. The separable stencils are shifted adds
in the reference's tap order with zero padding, so the plain versions here
round exactly as the JAX oracle does; this is also the arithmetic the CUDA
corner kernel (csrc/corner_nms.cu) reproduces.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# BT.601 luma weights — what cv2.cvtColor(BGR2GRAY)/RGB2GRAY uses.
_LUMA_RGB = (0.299, 0.587, 0.114)


def to_grayscale(img: torch.Tensor, channel_order: str = "rgb") -> torch.Tensor:
    """(H, W[, 3]) uint8/float -> (H, W) f32 grayscale in [0, 255], on
    img's device."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        return img
    r, g, b = _LUMA_RGB
    w = torch.tensor([r, g, b] if channel_order == "rgb" else [b, g, r],
                     dtype=torch.float32, device=img.device)
    return torch.tensordot(img, w, dims=([-1], [0]))


def _filt1d(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """1-D correlation along `axis` (0 = rows, 1 = columns of the last two
    dims) with static taps, SAME zero padding, as shifted adds in tap order."""
    taps = [float(t) for t in taps]
    r = len(taps) // 2
    dim = img.ndim - 2 + axis
    pad = [0, 0, 0, 0]  # F.pad order: (left, right, top, bottom)
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
    return out if out is not None else torch.zeros_like(img)


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (gx, gy), SAME zero padding.
    sobel_x = [1,2,1]_y (x) [-1,0,1]_x."""
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    gx = _filt1d(_filt1d(img, smooth, 0), diff, 1)
    gy = _filt1d(_filt1d(img, smooth, 1), diff, 0)
    return gx, gy


def box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box sum (not mean) over a size x size window, SAME padding."""
    ones = (1.0,) * size
    return _filt1d(_filt1d(img, ones, 0), ones, 1)


def gaussian_kernel1d(sigma: float, radius: int | None = None, *,
                      device: torch.device | str) -> torch.Tensor:
    """Normalised f32 Gaussian taps over [-radius, radius] (default
    max(1, ceil(3 sigma))), computed in f32 on `device`."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur, SAME padding (statically unrolled taps,
    computed in float64 on the host exactly as the reference does, not
    through the f32 `gaussian_kernel1d`)."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    return _filt1d(_filt1d(img, k, 1), k, 0)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x downsample (blur then stride-2)."""
    return gaussian_blur(img, 1.0, radius=2)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Gaussian pyramid, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def image_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients 0.5*(I[x+1]-I[x-1]), zero at the border."""
    gx = torch.zeros_like(img)
    gx[..., :, 1:-1] = 0.5 * (img[..., :, 2:] - img[..., :, :-2])
    gy = torch.zeros_like(img)
    gy[..., 1:-1, :] = 0.5 * (img[..., 2:, :] - img[..., :-2, :])
    return gx, gy


def bilinear_sample(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at float (x, y) locations pts (..., 2), or img
    (B, H, W) at pts (B, ..., 2); coordinates are clamped to the image."""
    h, w = img.shape[-2:]
    x = torch.clamp(pts[..., 0], 0.0, w - 1.000001)
    y = torch.clamp(pts[..., 1], 0.0, h - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    lead = img.shape[:-2]
    flat = img.reshape(lead + (h * w,))

    def at(yy, xx):
        idx = (yy * w + xx).reshape(lead + (-1,))
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
