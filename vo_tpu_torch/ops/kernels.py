"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Four TPU kernels exist (vo_tpu/ops/pallas_kernels.py): two on the
single-sequence path and their (B, ...) grid twins for the multi-sequence
mode. Two CUDA C++ kernels for Hopper (sm_90a) in vo_tpu_torch/csrc/, built
by ops/_build.py and launched through ctypes on PyTorch's current stream,
compute all four:

  K1 / K1b corner_response_nms — csrc/corner_nms.cu   (detection, once per step)
  K2 / K2b extract_patches     — csrc/patch_gather.cu (LK patch gather, 8 per step)

Each kernel takes a leading batch dimension (the lane is a grid dimension),
so B lanes are ONE launch, not B.

Beside each kernel sits its plain PyTorch version — the CPU path and the
kernel's oracle. A wrapper dispatches on the tensor's device: a CPU tensor
gets the plain version; a CUDA tensor gets the kernel or an exception (no
fallback). `use_kernel=False` asks for the plain version on purpose (the
`--no-pallas` twin); `use_kernel=True` with a CPU tensor raises.

Each wrapper adds one to `launch_counts[name]` where it launches its kernel
and nowhere else, so a run can prove which path it took. A launch over more
than one lane counts under the `_batched` name (K1b, K2b), any other under
the plain name (K1, K2).
"""

from __future__ import annotations

import torch

from vo_tpu_torch.ops.harris import (
    harris_response,
    nms_masked_response,
    shi_tomasi_response,
)

launch_counts = {
    "corner_response_nms": 0,
    "corner_response_nms_batched": 0,
    "extract_patches": 0,
    "extract_patches_batched": 0,
}

_MODES = {"shi_tomasi": 0, "harris": 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _wants_kernel(t: torch.Tensor, use_kernel: bool | None) -> bool:
    if use_kernel is False:
        return False
    if t.is_cuda:
        return True
    if use_kernel:
        raise ValueError("use_kernel=True needs a CUDA tensor; this one is on the CPU")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")


def empty_launch(device: torch.device) -> None:
    """Launch the empty kernel (csrc/empty_launch.cu) on `device`'s current
    stream: what a launch through this module's ctypes path costs with no
    work at all. It is a yardstick for timing, not part of any path, and
    has no launch count."""
    from vo_tpu_torch.ops._build import library

    lib = library()
    with torch.cuda.device(device):
        err = lib.vo_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error(err, "empty_launch")


# ---------------------------------------------------------------------------
# K1 — fused corner response + NMS
# ---------------------------------------------------------------------------

def corner_response_nms_plain(
    img: torch.Tensor,
    mode: str = "shi_tomasi",
    patch_size: int = 7,
    kappa: float = 0.08,
    nms_radius: int = 5,
) -> torch.Tensor:
    """(..., H, W) -> (..., H, W): the response at strict local maxima,
    -inf elsewhere — the unfused chain of ops/harris.py (shifted adds in
    tap order, separable window max)."""
    img = img.to(torch.float32)
    resp = (
        harris_response(img, patch_size, kappa)
        if mode == "harris"
        else shi_tomasi_response(img, patch_size)
    )
    return nms_masked_response(resp, nms_radius)


def corner_response_nms(
    img: torch.Tensor,
    mode: str = "shi_tomasi",
    patch_size: int = 7,
    kappa: float = 0.08,
    nms_radius: int = 5,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """Fused corner response + NMS masking; (H, W) or (B, H, W) f32.

    Replaces vo_tpu/ops/pallas_kernels.py::corner_response_nms (:196) and
    ::corner_response_nms_batched (:257). On the card the whole ~8-pass
    stencil chain runs as one kernel from one HBM read of the image
    (csrc/corner_nms.cu: a 32x32 tile plus a 2r + patch/2 + 1 halo per
    block in ~94 KB of shared memory); what bounds it is the shared-memory
    passes and block barriers, not HBM bytes.
    """
    if not _wants_kernel(img, use_kernel):
        return corner_response_nms_plain(img, mode, patch_size, kappa, nms_radius)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    batched = img.ndim == 3
    imgs = img if batched else img.unsqueeze(0)
    _check(imgs, "img", torch.float32, 3)
    b, h, w = imgs.shape
    if h * w > 1 << 24:
        # The NMS tie-break pools flat indices as f32, exact up to 2^24.
        raise ValueError(f"a {h}x{w} image has more than 2^24 pixels")
    out = torch.empty_like(imgs)
    from vo_tpu_torch.ops._build import library

    lib = library()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = lib.vo_corner_response_nms(
            imgs.data_ptr(), out.data_ptr(), b, h, w, _MODES[mode],
            patch_size, float(kappa), nms_radius, stream,
        )
    _raise_on_error(err, "corner_response_nms")
    launch_counts["corner_response_nms_batched" if b > 1 else "corner_response_nms"] += 1
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# K2 — patch gather at integer corners
# ---------------------------------------------------------------------------

def extract_patches_plain(
    img: torch.Tensor, corners: torch.Tensor, size: int
) -> torch.Tensor:
    """(H, W) + (K, 2) -> (K, size, size), or (B, H, W) + (B, K, 2) ->
    (B, K, size, size): windows at integer (x, y) corners, each start
    normalized and clamped into the image exactly as lax.dynamic_slice
    does it (a negative start counts from the end)."""
    batched = img.ndim == 3
    imgs = img if batched else img[None]
    cor = corners if batched else corners[None]
    b, h, w = imgs.shape
    # lax.dynamic_slice semantics: a negative start counts from the end,
    # then every start is clamped so the window fits.
    x0 = cor[..., 0].long()
    y0 = cor[..., 1].long()
    x0 = torch.where(x0 < 0, x0 + w, x0).clamp(0, w - size)
    y0 = torch.where(y0 < 0, y0 + h, y0).clamp(0, h - size)
    ar = torch.arange(size, device=img.device)
    rows = (y0[..., None] + ar)[..., :, None]  # (B, K, size, 1)
    cols = (x0[..., None] + ar)[..., None, :]  # (B, K, 1, size)
    bidx = torch.arange(b, device=img.device)[:, None, None, None]
    out = imgs[bidx, rows, cols]
    return out if batched else out[0]


def extract_patches(
    img: torch.Tensor,
    corners: torch.Tensor,
    size: int,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """Patch gather: (H, W) f32 + (K, 2) int32 -> (K, size, size), or the
    batched (B, H, W) + (B, K, 2) -> (B, K, size, size).

    Replaces vo_tpu/ops/pallas_kernels.py::extract_patches_aligned (:387) and
    ::extract_patches_aligned_batched (:464). On the card it is one block per
    keypoint copying size^2 floats (csrc/patch_gather.cu), bit-identical to
    the clamped gather; at the LK shapes it moves a few MB, so launch latency
    bounds it.
    """
    if not _wants_kernel(img, use_kernel):
        return extract_patches_plain(img, corners, size)
    batched = img.ndim == 3
    imgs = img if batched else img.unsqueeze(0)
    cor = corners if batched else corners.unsqueeze(0)
    _check(imgs, "img", torch.float32, 3)
    _check(cor, "corners", torch.int32, 3)
    b, h, w = imgs.shape
    if cor.shape[0] != b or cor.shape[2] != 2:
        raise ValueError(f"corners must be ({b}, K, 2), got {tuple(cor.shape)}")
    if cor.device != imgs.device:
        raise ValueError("img and corners must be on the same device")
    if not 0 < size <= min(h, w):
        raise ValueError(f"patch size {size} does not fit a {h}x{w} image")
    k = cor.shape[1]
    out = torch.empty((b, k, size, size), dtype=torch.float32, device=imgs.device)
    from vo_tpu_torch.ops._build import library

    lib = library()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = lib.vo_extract_patches(
            imgs.data_ptr(), cor.data_ptr(), out.data_ptr(), b, h, w, k, size, stream,
        )
    _raise_on_error(err, "extract_patches")
    launch_counts["extract_patches_batched" if b > 1 else "extract_patches"] += 1
    return out if batched else out[0]
