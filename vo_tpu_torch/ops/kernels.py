"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Four TPU kernels exist (vo_tpu/ops/pallas_kernels.py): two on the
single-sequence path and their (B, ...) grid twins for the multi-sequence
mode. Two CUDA C++ kernels for Hopper (sm_90a) in vo_tpu_torch/csrc/, built
by ops/_build.py and launched through ctypes on PyTorch's current stream,
compute all four; a third computes what the JAX package leaves to XLA after
the gathers:

  K1 / K1b corner_response_nms — csrc/corner_nms.cu   (detection, once per step)
  K2 / K2b extract_patches     — csrc/patch_gather.cu (LK patch gathers, one
           extract_patch_pairs   launch per pyramid level, 4 per step)
  lk_solve                     — csrc/lk_solve.cu     (LK's solve on the pair's
                                 patches, one launch per pyramid level)
  ba_solve                     — csrc/ba_solve.cu     (BA's camera system, one
                                 launch per Gauss-Newton iteration)

Each kernel takes a leading batch dimension (the lane is a grid dimension),
so B lanes are ONE launch, not B. The gather kernel also takes two jobs, so
the template and the search windows of one LK level are ONE launch
(`extract_patch_pairs`); `extract_patches` launches the same kernel with
one job.

Beside each kernel sits its plain PyTorch version — the CPU path and the
kernel's oracle. A wrapper dispatches on the tensor's device: a CPU tensor
gets the plain version; a CUDA tensor gets the kernel or an exception (no
fallback). `use_kernel=False` asks for the plain version on purpose (the
`--no-pallas` twin); `use_kernel=True` with a CPU tensor raises.

Each wrapper adds one to `launch_counts[name]` where it launches its kernel
and nowhere else, so a run can prove which path it took. Inside a CUDA graph
the launch happens at each replay, not when Python calls the wrapper: the
captured rollout (models/graphed.py) captures under `uncounted` and adds
each graph's launches at every replay. A launch over more
than one lane counts under the `_batched` name (K1b, K2b), any other under
the plain name (K1, K2); a launch of the pair counts once, under the
gather's names.

BA's solve runs inside a conditional body of the frame's graph, where a
replay cannot tell the host whether it ran. Its wrapper's calls, eager
launches and captures alike, are tallied on the host in `device_calls`
(never in `launch_counts`), and a capture holds its graph's nodes against
them. Its replays count on the device (`DEVICE_COUNTED`): inside
`counting_on_device`, which a runner sets around its capture, each launch
adds one, from one thread, to the runner's int64 slot of the kernel.

On an H100 every kernel's byte bound lies below what one launch through
this ctypes path costs the host, so the wrappers keep their own work small:
the checks are one boolean chain (the named errors are raised only after it
fails), no view of an input is made for the sake of a check, and the device
context is entered only for a tensor that is not on the current device.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from vo_tpu_torch.ops.harris import (
    harris_response,
    nms_masked_response,
    shi_tomasi_response,
)
from vo_tpu_torch.ops.linalg import spd_solve_blocked

launch_counts = {
    "corner_response_nms": 0,
    "corner_response_nms_batched": 0,
    "extract_patches": 0,
    "extract_patches_batched": 0,
    "lk_solve": 0,
    "lk_solve_batched": 0,
}

# The __global__ function (csrc/) that each counter's launches run: its name
# is in the kernel's node of a CUDA graph and in a profiler trace.
SYMBOLS = {
    "corner_response_nms": "corner_nms_kernel",
    "corner_response_nms_batched": "corner_nms_kernel",
    "extract_patches": "patch_gather_kernel",
    "extract_patches_batched": "patch_gather_kernel",
    "lk_solve": "lk_solve_kernel",
    "lk_solve_batched": "lk_solve_kernel",
}

# Kernels counted on the device: counter -> the __global__ function.
DEVICE_COUNTED = {"ba_solve": "ba_solve_kernel"}
device_calls = {name: 0 for name in DEVICE_COUNTED}
_device_slots: torch.Tensor | None = None  # set by `counting_on_device`

_MODES = {"shi_tomasi": 0, "harris": 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@contextlib.contextmanager
def uncounted():
    """Launches made inside do not count. A CUDA graph's capture records the
    launches of its segment (its replays count them: models/graphed.py),
    and the warm-up that capture needs runs on a scratch copy of the state:
    neither is a launch of the path."""
    saved, saved_calls = dict(launch_counts), dict(device_calls)
    try:
        yield
    finally:
        launch_counts.update(saved)
        device_calls.update(saved_calls)


@contextlib.contextmanager
def counting_on_device(slots: torch.Tensor):
    """Launches of the `DEVICE_COUNTED` kernels on `slots`' device add one to
    their int64 slot of `slots` (in `DEVICE_COUNTED`'s order) inside: a CUDA
    graph captured here adds to it at every replay. Elsewhere they count
    nothing on the device."""
    global _device_slots
    saved, _device_slots = _device_slots, slots
    try:
        yield
    finally:
        _device_slots = saved


def _count_slot(device: torch.device, name: str) -> int | None:
    """The address of counter `name`'s slot set by `counting_on_device` on
    `device`, else None (the kernel counts nothing)."""
    if _device_slots is None or _device_slots.device != device:
        return None
    return _device_slots.data_ptr() + 8 * list(DEVICE_COUNTED).index(name)


def _wants_kernel(t: torch.Tensor, use_kernel: bool | None) -> bool:
    if use_kernel is False:
        return False
    if t.is_cuda:
        return True
    if use_kernel:
        raise ValueError("use_kernel=True needs a CUDA tensor; this one is on the CPU")
    return False


def _ok(t: torch.Tensor, dtype: torch.dtype, ndim: int) -> bool:
    return t.is_cuda and t.dtype == dtype and t.ndim == ndim and t.is_contiguous()


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


def _launch(device: torch.device, kernel: str, fn, *args) -> None:
    """Call the C launcher `fn(*args, stream)` on `device`'s current stream
    and raise if the launch was refused. The device context is entered only
    when `device` is not already the current one."""
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, kernel)


def empty_launch(device: torch.device) -> None:
    """Launch the empty kernel (csrc/empty_launch.cu) on `device`'s current
    stream: what a launch through this module's ctypes path costs with no
    work at all. It is a yardstick for timing, not part of any path, and
    has no launch count."""
    from vo_tpu_torch.ops._build import library

    _launch(torch.device(device), "empty_launch", library().vo_empty_launch)


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
    ::corner_response_nms_batched (:257). On the card the whole stencil
    chain runs as one kernel from one HBM read of the image
    (csrc/corner_nms.cu: a 512-thread block per 64x40 tile plus a
    2r + patch/2 + 1 halo in ~123 KB of shared memory, seven passes; 640x480
    is 120 blocks, one wave). The pairs the configuration uses (patch 7
    with r 8 or 5) and the functions' own defaults (9, 5) have instances
    compiled with both as constants; any other pair runs the generic,
    slower instance of the same kernel. What bounds it is the latency of
    the shared-memory passes and block barriers, not HBM bytes.
    """
    if not _wants_kernel(img, use_kernel):
        return corner_response_nms_plain(img, mode, patch_size, kappa, nms_radius)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    if not (img.ndim in (2, 3) and _ok(img, torch.float32, img.ndim)):
        _check(img, "img", torch.float32, 3 if img.ndim != 2 else 2)
    h, w = img.shape[-2:]
    b = img.shape[0] if img.ndim == 3 else 1
    if h * w > 1 << 24:
        # The NMS tie-break pools flat indices as f32, exact up to 2^24.
        raise ValueError(f"a {h}x{w} image has more than 2^24 pixels")
    out = torch.empty_like(img)
    from vo_tpu_torch.ops._build import library

    _launch(img.device, "corner_response_nms", library().vo_corner_response_nms,
            img.data_ptr(), out.data_ptr(), b, h, w, _MODES[mode],
            patch_size, float(kappa), nms_radius)
    launch_counts["corner_response_nms_batched" if b > 1 else "corner_response_nms"] += 1
    return out


def corner_nms_launch_info(patch_size: int, nms_radius: int, device: torch.device) -> dict:
    """How the corner kernel launches for (patch_size, nms_radius) on
    `device`: whether that pair has a specialised instance, the tile, the
    threads and shared memory of a block, the blocks an SM can hold
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the SM count."""
    from vo_tpu_torch.ops._build import library

    info = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = library().vo_corner_nms_launch_info(patch_size, nms_radius, info)
    _raise_on_error(err, "corner_nms_launch_info")
    keys = ("specialised", "tile_w", "tile_h", "threads", "smem_bytes", "blocks_per_sm", "sms")
    return dict(zip(keys, info))


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
    keypoint copying size^2 floats (csrc/patch_gather.cu, the kernel that
    `extract_patch_pairs` launches with two jobs), bit-identical to the
    clamped gather. It moves a few MB, microseconds at HBM rate: what it
    costs is the launch, on the host.
    """
    if not _wants_kernel(img, use_kernel):
        return extract_patches_plain(img, corners, size)
    nd = img.ndim
    if not (nd in (2, 3) and _ok(img, torch.float32, nd) and _ok(corners, torch.int32, nd)):
        nd = 2 if nd == 2 else 3
        _check(img, "img", torch.float32, nd)
        _check(corners, "corners", torch.int32, nd)
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    b = lead[0] if lead else 1
    k = corners.shape[-2]
    if corners.shape != lead + (k, 2):
        raise ValueError(f"corners must be {tuple(lead) + ('K', 2)}, got {tuple(corners.shape)}")
    if corners.device != img.device:
        raise ValueError("img and corners must be on the same device")
    if not 0 < size <= min(h, w):
        raise ValueError(f"patch size {size} does not fit a {h}x{w} image")
    out = torch.empty(lead + (k, size, size), dtype=torch.float32, device=img.device)
    from vo_tpu_torch.ops._build import library

    _launch(img.device, "extract_patches", library().vo_extract_patches,
            img.data_ptr(), corners.data_ptr(), out.data_ptr(), b, h, w, k, size)
    launch_counts["extract_patches_batched" if b > 1 else "extract_patches"] += 1
    return out


# ---------------------------------------------------------------------------
# K2 as the LK caller uses it — both gathers of a level, no padded copies
# ---------------------------------------------------------------------------

def pad_replicate(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate padding of the last two dims of (H, W) or (B, H, W)
    (F.pad's replicate mode wants two leading dims of its own)."""
    h, w = img.shape[-2:]
    out = F.pad(img.reshape((1, -1, h, w)), (pad,) * 4, mode="replicate")
    return out.reshape(img.shape[:-2] + (h + 2 * pad, w + 2 * pad))


def extract_patch_pairs_plain(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    tcorner: torch.Tensor,
    scorner: torch.Tensor,
    tsize: int,
    ssize: int,
    pad: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's way: edge-replicate both levels by `pad`, then gather
    tsize windows of `prev` at tcorner and ssize windows of `nxt` at scorner
    (corners in padded coordinates, dynamic_slice semantics)."""
    return (extract_patches_plain(pad_replicate(prev, pad), tcorner, tsize),
            extract_patches_plain(pad_replicate(nxt, pad), scorner, ssize))


def extract_patch_pairs(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    tcorner: torch.Tensor,
    scorner: torch.Tensor,
    tsize: int,
    ssize: int,
    pad: int,
    use_kernel: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both patch gathers of one Lucas-Kanade level: (H, W) levels + (K, 2)
    int32 corners -> ((K, tsize, tsize), (K, ssize, ssize)), or (B, H, W) +
    (B, K, 2) -> ((B, K, tsize, tsize), (B, K, ssize, ssize)).

    `prev` and `nxt` are the UNPADDED levels; the corners are (x, y) in the
    coordinates of the level edge-replicated by `pad` on every side, as the
    reference computes them. The result is what gathering from those padded
    copies returns (`extract_patch_pairs_plain`): pixel (y, x) of the padded
    level is pixel (clamp(y - pad, 0, H-1), clamp(x - pad, 0, W-1)) of the
    level. On the card that is ONE launch of csrc/patch_gather.cu for both
    gathers of all keypoints of all lanes, each thread clamping its own
    address, and the padded copies are never made.

    Precondition of the LK caller, not needed for the identity: with pad =
    radius + MARGIN + 2 and centres clamped into the image, every window lies
    inside the padded extent, so no start is clamped. Outside it, kernel and
    plain version both follow lax.dynamic_slice on the padded extent (a
    negative start counts from the end, then the start is clamped), so they
    agree bit for bit for every corner.
    """
    if not _wants_kernel(prev, use_kernel):
        return extract_patch_pairs_plain(prev, nxt, tcorner, scorner, tsize, ssize, pad)
    nd = prev.ndim
    if not (nd in (2, 3) and _ok(prev, torch.float32, nd) and _ok(nxt, torch.float32, nd)
            and _ok(tcorner, torch.int32, nd) and _ok(scorner, torch.int32, nd)):
        nd = 2 if nd == 2 else 3
        _check(prev, "prev", torch.float32, nd)
        _check(nxt, "nxt", torch.float32, nd)
        _check(tcorner, "tcorner", torch.int32, nd)
        _check(scorner, "scorner", torch.int32, nd)
    lead, (h, w) = prev.shape[:-2], prev.shape[-2:]
    b = lead[0] if lead else 1
    k = tcorner.shape[-2]
    if nxt.shape != prev.shape:
        raise ValueError(f"prev {tuple(prev.shape)} and nxt {tuple(nxt.shape)} differ in shape")
    if tcorner.shape != lead + (k, 2) or scorner.shape != tcorner.shape:
        raise ValueError(f"corners must both be {tuple(lead) + ('K', 2)}, got "
                         f"{tuple(tcorner.shape)} and {tuple(scorner.shape)}")
    dev = prev.device
    if not (nxt.device == dev and tcorner.device == dev and scorner.device == dev):
        raise ValueError("levels and corners must be on the same device")
    if pad < 0 or not 0 < min(tsize, ssize) <= max(tsize, ssize) <= min(h, w) + 2 * pad:
        raise ValueError(f"patch sizes {tsize}, {ssize} do not fit a {h}x{w} level "
                         f"padded by {pad}")
    # Two allocations, not one carved in two: an allocation dispatches one
    # op, a carved view two more, and the host's dispatch is what a launch
    # costs here.
    tout = torch.empty(lead + (k, tsize, tsize), dtype=torch.float32, device=dev)
    sout = torch.empty(lead + (k, ssize, ssize), dtype=torch.float32, device=dev)
    from vo_tpu_torch.ops._build import library

    _launch(dev, "extract_patch_pairs", library().vo_extract_patch_pairs,
            prev.data_ptr(), nxt.data_ptr(), tcorner.data_ptr(), scorner.data_ptr(),
            tout.data_ptr(), sout.data_ptr(), b, h, w, k, tsize, ssize, pad)
    launch_counts["extract_patches_batched" if b > 1 else "extract_patches"] += 1
    return tout, sout


# ---------------------------------------------------------------------------
# LK's solve on the pair's patches — one launch per pyramid level
# ---------------------------------------------------------------------------

def lk_solve(
    tpatch: torch.Tensor,
    spatch: torch.Tensor,
    tfrac: torch.Tensor,
    s_base: torch.Tensor,
    guess: torch.Tensor,
    radius: int,
    max_iters: int,
    eps: float,
    min_eig_threshold: float,
    actives: list | None = None,
    use_kernel: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lucas-Kanade level after its patch pair: (K, 2) points, or (B, K,
    2) over lanes, with the (..., K, 2r+5, 2r+5) templates and (..., K, S, S)
    search patches that `extract_patch_pairs` gathered around them. `tfrac`
    is each template centre's sub-pixel offset from its patch's grid, `s_base`
    the search window's origin inside its patch before any update, as
    `ops/klt.py::_lk_level` computes them beside the pair's corners. Returns
    (guess + d (..., K, 2), conditioned (..., K) bool, err (..., K)); where a
    list `actives` is given, appends to it the (..., K) int32 count, per
    point, of the iterations that moved it.

    The plain version is `ops/klt.py::lk_solve_plain` (the reference's
    arithmetic: dense tent-matrix resamples, a fixed trip count with a masked
    update). On the card it is ONE launch of csrc/lk_solve.cu for all points
    of all lanes: a warp a point, each point stopping when it converges. The
    two agree to a few ulps (sums over a window in another order), not bit
    for bit.

    The shapes are checked on both routes; the kernel also wants float32
    (the plain version takes any float dtype).
    """
    win = 2 * radius + 1
    lead, k = guess.shape[:-2], guess.shape[-2]
    ssize = spatch.shape[-1]
    pts = lead + (k, 2)
    if not (len(lead) <= 1 and guess.shape == pts and tfrac.shape == pts
            and s_base.shape == pts and tpatch.shape == lead + (k, win + 4, win + 4)
            and spatch.shape == lead + (k, ssize, ssize) and ssize >= win + 2):
        raise ValueError(
            f"lk_solve wants (K, 2) or (B, K, 2) offsets, origins and guesses, templates "
            f"(..., K, {win + 4}, {win + 4}) and square search patches of at least "
            f"{win + 2} for radius {radius}; got offsets {tuple(tfrac.shape)}, origins "
            f"{tuple(s_base.shape)}, guesses {tuple(guess.shape)}, templates "
            f"{tuple(tpatch.shape)}, search patches {tuple(spatch.shape)}")
    if not _wants_kernel(spatch, use_kernel):
        # ops/klt.py imports this module: the plain version is found at call time.
        from vo_tpu_torch.ops.klt import lk_solve_plain

        return lk_solve_plain(tpatch, spatch, tfrac, s_base, guess, radius, max_iters, eps,
                              min_eig_threshold, actives)
    f32 = torch.float32
    if not all(t.dtype == f32 for t in (tpatch, spatch, tfrac, s_base, guess)):
        raise TypeError(f"lk_solve's kernel wants float32 patches, offsets, origins and "
                        f"guesses; got {tpatch.dtype}, {spatch.dtype}, {tfrac.dtype}, "
                        f"{s_base.dtype}, {guess.dtype}")
    # The step's motion prediction hands the first level a guess laid out as
    # its (..., 2, K) products were: the kernel reads (..., K, 2) rows.
    tfrac, s_base, guess = tfrac.contiguous(), s_base.contiguous(), guess.contiguous()
    dev = spatch.device
    if not all(t.device == dev and t.is_contiguous()
               for t in (tpatch, spatch, tfrac, s_base, guess)):
        raise ValueError("patches, offsets, origins and guesses must be contiguous and on "
                         "one CUDA device")
    flow = torch.empty(pts, dtype=f32, device=dev)
    conditioned = torch.empty(lead + (k,), dtype=torch.bool, device=dev)
    err = torch.empty(lead + (k,), dtype=f32, device=dev)
    live = None if actives is None else torch.empty(lead + (k,), dtype=torch.int32,
                                                     device=dev)
    b = lead[0] if lead else 1
    from vo_tpu_torch.ops._build import library

    # The plain version compares and clamps with these Python numbers cast to
    # float32; ctypes rounds them the same way.
    _launch(dev, "lk_solve", library().vo_lk_solve,
            tpatch.data_ptr(), spatch.data_ptr(), tfrac.data_ptr(), s_base.data_ptr(),
            guess.data_ptr(), flow.data_ptr(), conditioned.data_ptr(), err.data_ptr(),
            None if live is None else live.data_ptr(), b, k, radius, win + 4, ssize,
            max_iters, eps * eps, min_eig_threshold, float(ssize - win - 1) - 1e-4)
    launch_counts["lk_solve_batched" if b > 1 else "lk_solve"] += 1
    if actives is not None:
        actives.append(live)
    return flow, conditioned, err


# ---------------------------------------------------------------------------
# BA's camera system — one launch per Gauss-Newton iteration
# ---------------------------------------------------------------------------

BA_SOLVE_MAX_N = 96  # W * block size: kMaxN of csrc/ba_solve.cu


def ba_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The SPD block system sum_j S[i, j] x_j = b_i of a BA window: S (W, W,
    nb, nb) and b (W, nb), or (B, W, W, nb, nb) and (B, W, nb) over lanes;
    only S's lower block triangle is read. Returns x shaped as b.

    On the CPU: `ops/linalg.py::spd_solve_blocked`, the blocked Cholesky,
    which is also the kernel's oracle. On the card: ONE launch of
    csrc/ba_solve.cu for all lanes, a block a lane: the Cholesky factor of
    the dense (W nb) x (W nb) matrix read through S's strides (no copy),
    chol_small's roundings, each element's terms in ascending order, then
    both substitutions. The two agree to the system's condition in f32, not
    bit for bit; a lane equals its single run bit for bit on either. A
    call counts in `device_calls`, a runner's replay of it on the device
    (`DEVICE_COUNTED`), so a CUDA graph's conditional body may hold it. float32 only; W nb at most
    `BA_SOLVE_MAX_N`. There is no `use_kernel`: the tensor's device alone
    decides, so the card never runs two solvers for one system.
    """
    if not S.is_cuda:
        return spd_solve_blocked(S, b)
    lead = S.shape[:-4]
    W, nb = S.shape[-4], S.shape[-1]
    if not (len(lead) <= 1 and S.shape == lead + (W, W, nb, nb) and b.shape == lead + (W, nb)):
        raise ValueError(f"ba_solve wants S (W, W, nb, nb) and b (W, nb), or both with one "
                         f"lane axis; got {tuple(S.shape)} and {tuple(b.shape)}")
    if S.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"ba_solve's kernel wants float32; got {S.dtype} and {b.dtype}")
    if b.device != S.device:
        raise ValueError("S and b must be on one CUDA device")
    if W * nb > BA_SOLVE_MAX_N:
        raise ValueError(f"ba_solve's kernel takes W * nb up to {BA_SOLVE_MAX_N}; got "
                         f"W = {W}, nb = {nb}")
    dev = S.device
    x = torch.empty(b.shape, dtype=torch.float32, device=dev)
    ss, bs = S.stride(), b.stride()
    from vo_tpu_torch.ops._build import library

    _launch(dev, "ba_solve", library().vo_ba_solve,
            S.data_ptr(), b.data_ptr(), x.data_ptr(), lead[0] if lead else 1, W, nb,
            ss[0] if lead else 0, *ss[-4:], bs[0] if lead else 0, *bs[-2:],
            _count_slot(dev, "ba_solve"))
    device_calls["ba_solve"] += 1
    return x
