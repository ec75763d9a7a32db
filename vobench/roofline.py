"""The yardstick of the kernels' roofline shares: the card's published
peaks and, from launch shapes alone, the bytes and operations each
hand-written kernel of the step must move. A copy of the arithmetic of
the port's `chip_smoke.py` (`_k1_bound`, `_pair_bound`) and
`tools/roofline_torch.py`, kept here so that a later kernel is judged
against the same count of work.

A bound counts each input byte read once and each output byte written
once; the least time is the larger of bytes over the HBM rate and
operations over the float32 rate (no tensor cores: the kernels are f32
stencils and gathers).
"""

from __future__ import annotations

from vobench.trace import kernel_seconds

# NVIDIA H100 SXM (data sheet, dense, 700 W): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# K1's arithmetic per pixel: Sobel 14, gradient products 3, three 7x7
# separable box sums 3 * (6 + 6), the eigenvalue or Harris score 10, the
# (2r+1)^2 separable window max and its index pass 64, the mask 3.
K1_FLOP_PER_PIXEL = 14 + 3 + 36 + 10 + 64 + 3

# The LK patch pair of one pyramid level: a 21x21 template and a 35x35
# search patch a corner (ops/klt.py: window 17 + 4, and 17 + 2 * 8 + 2).
LK_TEMPLATE, LK_SEARCH = 21, 35


def bound_s(n_bytes: float, n_flop: float) -> float:
    """The least time the card could take for one launch."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S)


def k1_bound_s(lanes: int, height: int, width: int) -> float:
    """The corner kernel (K1, or K1b over lanes) reads the image once and
    writes the masked response once."""
    n = lanes * height * width
    return bound_s(2 * n * 4, n * K1_FLOP_PER_PIXEL)


def pyramid_shapes(height: int, width: int, levels: int) -> list[tuple[int, int]]:
    """The levels of the port's pyramid (ops/image.py `downsample2`: a
    stride-2 slice, so odd sizes round up)."""
    shapes = [(height, width)]
    for _ in range(levels - 1):
        h, w = shapes[-1]
        shapes.append(((h + 1) // 2, (w + 1) // 2))
    return shapes


def pair_bound_s(lanes: int, height: int, width: int, corners: int) -> float:
    """One launch of the LK patch pair (K2, or K2b over lanes) on one
    level: both patch sets written once, from each of the two levels the
    pixels gathered read once (at most the whole level), both corner sets
    read; no arithmetic."""
    n_img = lanes * height * width
    n_t = lanes * corners * LK_TEMPLATE * LK_TEMPLATE
    n_s = lanes * corners * LK_SEARCH * LK_SEARCH
    n_cor = 2 * lanes * corners * 2
    return bound_s((n_t + n_s + min(n_t, n_img) + min(n_s, n_img) + n_cor) * 4, 0)


def k2_step_bound_s(lanes: int, height: int, width: int, corners: int,
                    levels: int) -> float:
    """The pairs of one step: one launch a pyramid level."""
    return sum(pair_bound_s(lanes, h, w, corners)
               for h, w in pyramid_shapes(height, width, levels))


K1_SYMBOL = "corner_nms_kernel"  # csrc/corner_nms.cu, K1 and K1b
K2_SYMBOL = "patch_gather_kernel"  # csrc/patch_gather.cu, the K2 and K2b pairs


def k1_share_pct(s, lanes: int, height: int, width: int) -> float | None:
    """K1's bounds over its kernel times in the traced slice `s`, in %;
    None where the slice holds none of its launches."""
    n, seconds = kernel_seconds(s, K1_SYMBOL)
    if n == 0 or seconds <= 0.0:
        return None
    return 100.0 * n * k1_bound_s(lanes, height, width) / seconds


def k2_share_pct(s, lanes: int, height: int, width: int, corners: int,
                 levels: int) -> float | None:
    """The pairs' bounds over their kernel times in `s`, in %: one launch a
    level a step, so None where the launches are not whole steps."""
    n, seconds = kernel_seconds(s, K2_SYMBOL)
    if n == 0 or n % levels or seconds <= 0.0:
        return None
    steps = n // levels
    return 100.0 * steps * k2_step_bound_s(lanes, height, width, corners, levels) / seconds
