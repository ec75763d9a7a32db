"""Harris / Shi-Tomasi corner detection with top-K non-maximum suppression —
port of the detection half of vo_tpu/ops/harris.py.

  * response map = Sobel + structure-tensor box sums (ops/image.py);
  * NMS = (2r+1)^2 window max with a flat-index tie-break;
  * selection = one stable top-k over the flattened masked response, a FIXED
    number of slots with a validity mask.

On a CUDA tensor `detect_keypoints` runs the response + NMS chain as ONE
hand-written kernel (ops/kernels.py `corner_response_nms`, K1).

Every function takes (H, W) or, with a leading lane axis, (B, H, W): the
selection (quality floor, top-k, tie order) is per lane, and a batch of
images on the card is ONE launch of the kernel (K1b).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vo_tpu_torch.ops.image import box_filter, sobel


def structure_tensor(img: torch.Tensor, patch_size: int = 9):
    """(Sxx, Syy, Sxy) box-summed gradient products."""
    gx, gy = sobel(img)
    sxx = box_filter(gx * gx, patch_size)
    syy = box_filter(gy * gy, patch_size)
    sxy = box_filter(gx * gy, patch_size)
    return sxx, syy, sxy


def harris_response(img: torch.Tensor, patch_size: int = 9, kappa: float = 0.08) -> torch.Tensor:
    """det(M) - kappa * trace(M)^2, clamped at 0."""
    sxx, syy, sxy = structure_tensor(img, patch_size)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return torch.clamp(det - kappa * tr * tr, min=0.0)


def shi_tomasi_response(img: torch.Tensor, patch_size: int = 7) -> torch.Tensor:
    """Minimum eigenvalue of the structure tensor, clamped at 0."""
    sxx, syy, sxy = structure_tensor(img, patch_size)
    half_tr = 0.5 * (sxx + syy)
    d = sxx - syy
    rad = torch.sqrt(torch.clamp(0.25 * (d * d) + sxy * sxy, min=0.0))
    return torch.clamp(half_tr - rad, min=0.0)


class Keypoints(NamedTuple):
    xy: torch.Tensor  # (..., K, 2) float32 (x, y) pixel coordinates
    score: torch.Tensor  # (..., K) response values
    valid: torch.Tensor  # (..., K) bool


def _window_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 running max over the last two dims, -inf padding (separable;
    max is exact, so rows-then-columns equals the 2-D window)."""
    n_h, n_w = x.shape[-2:]
    p = F.pad(x, (0, 0, radius, radius), value=-float("inf"))
    out = x
    for i in range(2 * radius + 1):
        if i != radius:
            out = torch.maximum(out, p[..., i:i + n_h, :])
    p = F.pad(out, (radius, radius), value=-float("inf"))
    res = out
    for i in range(2 * radius + 1):
        if i != radius:
            res = torch.maximum(res, p[..., :, i:i + n_w])
    return res


def nms_masked_response(response: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """Response at strict local maxima of a (2r+1)^2 window, -inf elsewhere.
    Ties between equal maxima go to the largest flat index (second pooling
    pass over the flat index as f32, exact up to 2^24)."""
    h, w = response.shape[-2:]
    pooled = _window_max(response, nms_radius)
    idx_f = torch.arange(h * w, device=response.device, dtype=torch.int32)
    idx_f = idx_f.reshape(h, w).to(torch.float32)
    tied_idx = torch.where(response >= pooled, idx_f, -1.0)
    pooled_idx = _window_max(tied_idx, nms_radius)
    is_max = (response >= pooled) & (idx_f == pooled_idx)
    return torch.where(is_max, response, -float("inf"))


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` semantics over the last axis: the k largest values,
    and among equal values the lower index first (torch.topk promises no
    tie order; slot order decides uid assignment downstream)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_from_masked(
    masked: torch.Tensor,
    num_keypoints: int,
    border: int = 0,
    min_response: float = 0.0,
    quality_level: float = 0.0,
) -> Keypoints:
    """Top-K selection tail over an NMS-masked response map (..., H, W)."""
    w = masked.shape[-1]
    keep = masked > min_response
    if quality_level > 0.0:
        # The global max is itself a local max, so max(masked) == max(resp).
        keep = keep & (masked > quality_level * masked.amax(dim=(-2, -1), keepdim=True))
    if border > 0:
        box = torch.zeros_like(keep)
        box[..., border:-border, border:-border] = True
        keep = keep & box
    flat = torch.where(keep, masked, -float("inf")).flatten(-2)
    scores, idx = top_k(flat, num_keypoints)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    valid = torch.isfinite(scores) & (scores > min_response)
    return Keypoints(
        xy=torch.stack([xs, ys], dim=-1),
        score=torch.where(valid, scores, 0.0),
        valid=valid,
    )


def select_keypoints(
    response: torch.Tensor,
    num_keypoints: int,
    nms_radius: int = 5,
    border: int = 0,
    min_response: float = 0.0,
    quality_level: float = 0.0,
) -> Keypoints:
    """Top-K local maxima of a response map, fixed output size."""
    return select_from_masked(
        nms_masked_response(response, nms_radius),
        num_keypoints,
        border=border,
        min_response=min_response,
        quality_level=quality_level,
    )


def detect_keypoints(
    image: torch.Tensor,
    num_keypoints: int,
    mode: str = "shi_tomasi",
    patch_size: int = 7,
    kappa: float = 0.08,
    nms_radius: int = 5,
    border: int = 0,
    min_response: float = 0.0,
    quality_level: float = 0.0,
    use_pallas: bool | None = None,
) -> Keypoints:
    """Corner detection front door: response + NMS + top-K.

    `use_pallas` keeps the reference's name: None runs the fused CUDA kernel
    for a CUDA tensor and the plain chain for a CPU one, False forces the
    plain chain, True demands the kernel. Both give identical keypoints.
    """
    from vo_tpu_torch.ops.kernels import corner_response_nms

    masked = corner_response_nms(
        image, mode=mode, patch_size=patch_size, kappa=kappa,
        nms_radius=nms_radius, use_kernel=use_pallas,
    )
    return select_from_masked(
        masked, num_keypoints,
        border=border, min_response=min_response, quality_level=quality_level,
    )
