#!/usr/bin/env python3
"""Smoke test of vo_tpu_torch on one CUDA GPU — the quickest proof that the
port builds, agrees with its plain PyTorch versions, and runs its main path.

    python3 chip_smoke.py            # the full runs of every phase but multiseq (150 frames)
    python3 chip_smoke.py --multiseq-frames 600   # ... and the six lanes at full length
    python3 chip_smoke.py --frames 60 --multiseq-frames 40 --harris-frames 60 \
        --sift-frames 24 --loop-frames 100        # a short rehearsal

Phases:
  1. identify the card (nvidia-smi name and power limit);
  2. `build`: the CUDA kernels from vo_tpu_torch/csrc (nvcc, sm_90a), and the
     time of an empty launch (the floor under every kernel time);
  3. `k1` corner_response_nms: kernel vs plain version on the card, the
     specialised (patch, r) instances and the generic one, shapes smaller
     than a tile and not a multiple of it, a batch of 3; timed at 480x640,
     with the blocks an SM, the grid and the waves of that launch;
  4. `k2` extract_patches: kernel vs plain, bit-identical, sizes 21/35,
     K=1024 on a 516x676 level (corners needing clamping included), a batch
     of 3; then extract_patch_pairs (both gathers of an LK level in one
     launch, no padded copies) against pad + two plain gathers, bit-identical,
     at the four level shapes of 640x480 with K=1024, corners on and beyond
     the border; timed at level 0 beside two single launches;
  5. `k1b`: the corner kernel over a batch of 6 lanes (6, 480, 640), against
     the plain version; both timed;
  6. `k2b`: the gather kernel over 6 lanes, (6, 516, 676) and the coarsest
     level (6, 96, 116) with (6, 512, 2) corners, sizes 21/35, bit-identical;
     then the pair over 6 lanes at the four level shapes; timed;
  7. `headline`: render the synthetic city on the device, check two frames
     against the numpy renderer, run bootstrap + vo_step over the sequence
     with VOConfig(capacity=1024), and gate the launch counts, finiteness,
     pose_ok count and ATE against exact ground truth;
  8. `multiseq`: the lockstep multi-sequence evaluation at full width (the
     entry points of run_multiseq_torch.py --full): six distinct cities,
     640x480, capacity 512, bootstrapped alone, stacked and rolled in
     lockstep in chunks of 64, then the distorted-lens lane on its own;
     gates the batched launch counts, finiteness, per-lane pose_ok and, at
     the full 600 frames a lane (`--multiseq-frames 600`; 150 by default),
     the ATE;
  9. `harris`, `sift`, `loop`: the entry point `run_vo_torch.py` through its
     own `run` function, at full width (640x480, capacity 1024). `harris`:
     `--tracker harris` over the 600-frame city (the corner kernel's
     (harris, 7, 5) instance twice at bootstrap and once a step, no gather
     launch), then its first 40 frames again, bit-equal. `sift`: `--tracker
     sift` over the first 150 frames (no kernel launch at all). `loop`:
     `--spec loop --pose-graph --chunk 16` over the 1,169-frame closed
     circuit (KLT + BA + the Sim(3) pose-graph back-end), gating the launch
     counts, the graph's size, the verified loops and the ATE before and
     after the correction; then the checkpoint written mid-run is resumed
     for 16 frames and held bit for bit against the straight run.
     Each prints one JSON line.
 10. `dist`: the distributed layer (vo_tpu_torch.parallel). (a) In a real
     single-rank NCCL group on cuda:0, the four sharded solvers at full width
     against their single-device functions: dist_gn (1,024 observations),
     dist_ba (the headline's last BA window) and dist_pg (the loop circuit's
     pose graph) bit for bit, seqpar (a composed 8 x 1,024 window) at the JAX
     package's tolerances. (b) Two ranks sharing cuda:0 over Gloo (NCCL
     refuses two ranks on one card): the multihost worker's --dist-ba and
     --seqpar-ba parity verdicts and its rollout (3 lanes a rank at 640x480,
     capacity 512, 16 steps: K1b once and K2b 4 times a step on each rank).
     (c) run_multiseq_torch.py --seqpar-shards 2 over 150 frames: the
     composed-window back-end must beat the rollout without it. Every part
     prints a JSON line with its world size, backend and device.

Every kernel time is taken twice: `ms` by CUDA events around 50 eager calls
of the wrapper (what the path pays; at these sizes mostly the host's enqueue)
and `device_ms` by replaying the same calls captured in a CUDA graph (what
the device needs once the host is out of the way).

Prints the card line, a JSON line describing every kernel (its times beside
its bound, the plain version and, where there is one, a single PyTorch
call), and as the last line {"ok": true, "device": {...}}. Any failed phase
exits non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REFERENCE_ATE_M = 1.181  # tools/headline_expected.json (the JAX package)
ATE_GATE_M = 1.77  # 1.5x the reference, just above its 1.753 m regression
POSE_OK_SLACK = 7  # pose_ok must hold on all but this many frames

# Shapes: not a multiple of the kernel's tile, less than one tile, full size.
K1_SHAPES = [(150, 260), (64, 200), (30, 40), (480, 640)]
# (mode, patch, r): the three specialised instances (the configuration's own
# values, and the defaults of harris_response / detect_keypoints), then a
# pair that only the generic instance takes.
K1_MODES = [("shi_tomasi", 7, 8), ("harris", 7, 5), ("harris", 9, 5), ("shi_tomasi", 5, 3)]
# The four pyramid levels of a 640x480 frame and the LK gathers on them:
# template windows of 21, search windows of 35, levels padded by 18.
LK_LEVEL_SHAPES = [(480, 640), (240, 320), (120, 160), (60, 80)]
LK_TSIZE, LK_SSIZE, LK_PAD = 21, 35, 18
# A window's corner lies this far up and left of its centre's pixel
# (radius + 2 for the template, radius + MARGIN for the search window).
LK_CORNER_OFFSET = {LK_TSIZE: 10, LK_SSIZE: 16}

# The multi-sequence phase. Per-lane ATE of the JAX package's own run of
# these lanes (EVAL.md, taken on a TPU): a yardstick of ACCURACY only.
MULTISEQ_LANES = 6
MULTISEQ_CAPACITY = 512
MULTISEQ_REFERENCE_ATE_M = {
    "city_lr": 1.64, "city_rl": 2.47, "scurve": 1.40, "stopgo": 1.05,
    "tight": 1.58, "longrun": 0.52, "distorted": 0.91,
}
# A lane passes at twice its yardstick, and never below 2 m: one RANSAC draw
# moves the port's ATE by a factor of two on the headline (0.66-1.37 m over
# four seeds), while a broken run is off by an order of magnitude.
MULTISEQ_ATE_FACTOR = 2.0
MULTISEQ_ATE_FLOOR_M = 2.0
# pose_ok must hold on 95% of a lane's frames (567 of 597).
MULTISEQ_POSE_OK_SHARE = 0.95

# The run_vo_torch phases. ATE yardsticks are the JAX package's own figures
# (EVAL.md, taken on a TPU): yardsticks of ACCURACY only.
HARRIS_REFERENCE_ATE_M = 4.237  # --tracker harris, 600 frames, one draw
# The harris tracker's ATE and pose_ok share follow the RANSAC draw, not the
# port: five seeds on an H100 gave 4.14-31.73 m and 459-597 of 597 frames,
# and the JAX package itself, in float32 on a CPU over the same frames
# (tests/torch_reference_tracker_run.py), gave 4.87-32.72 m with 476-525
# frames over three keys: in both the map starves at the second turn
# (PERF.md). Twice the yardstick is printed beside the reading; what fails
# the phase is what a broken front-end would show.
HARRIS_ATE_LIMIT_M = 40.0
HARRIS_POSE_OK_SHARE = 0.60
SIFT_REFERENCE_ATE_M = {150: 0.115, 600: 1.907}  # --tracker sift, by length
# A short run's ATE floor: 1% of the distance driven (0.3 m a frame).
SIFT_ATE_FLOOR_M_PER_FRAME = 0.003
LOOP_REFERENCE_RAW_ATE_M = 3.72  # BA only, the 1,169-frame circuit
LOOP_REFERENCE_PG_ATE_M = 2.07  # after the Sim(3) pose-graph correction
LOOP_FRAMES = 1169
LOOP_MIN_NODES = 70  # one keyframe a 16-frame chunk: 73
LOOP_MIN_LOOPS = 3  # the JAX package verified 9
LOOP_CHECKPOINT_EVERY = 600
REPEAT_FRAMES = 40  # the harris prefix that is run again, bit-equal
RUN_POSE_OK_SHARE = 0.95

# The distributed phase. Full width: a 1,024-observation pose, the headline's
# last BA window, the loop circuit's pose graph, a composed 8 x 1,024 window,
# two ranks of three 640x480 lanes at capacity 512, and --seqpar-shards 2.
DIST_GN_POINTS = 1024
DIST_SEQPAR_LANDMARKS, DIST_SEQPAR_WINDOW = 1024, 8
DIST_BA_LANDMARKS_PER_RANK = 512
DIST_ROLLOUT_LANES, DIST_ROLLOUT_STEPS = 3, 16
DIST_CLUSTER_TIMEOUT_S = 300
# The JAX package's --seqpar-shards 2 (README.md, a CPU run): accuracy only.
SEQPAR_YARDSTICK = {"ate_no_refine_m": 0.298, "ate_seqpar_m": 0.051}
# Inputs one phase leaves for a later one (the headline's BA window, the
# loop's pose graph).
HANDOFF: dict = {}

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Arithmetic of the corner kernel per pixel: Sobel 14, gradient products 3,
# three 7x7 separable box sums 3*(6+6), the eigenvalue or Harris score 10,
# two separable (2r+1)^2 max pools at r=8 2*(16+16), the maximum test 3.
K1_FLOP_PER_PIXEL = 14 + 3 + 36 + 10 + 64 + 3


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn() in ms over `reps` launches (CUDA events,
    after a warm-up)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of fn() in ms with the host out of the way: `reps` calls
    captured once in a CUDA graph (the ctypes launches go to the capturing
    stream) and the graph replayed `replays` times between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def _interleaved(plain, kernel) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain) -> (kernel_ms, plain_ms)."""
    p1 = _time_ms(plain)
    k1 = _time_ms(kernel)
    k2 = _time_ms(kernel)
    p2 = _time_ms(plain)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def _bound(record: dict, n_bytes: float, n_flop: float) -> None:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the f32 rate."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_flop = 1e3 * n_flop / F32_FLOP_PER_S
    record.update(bound_ms=max(t_bytes, t_flop),
                  bound_by="bytes" if t_bytes >= t_flop else "operations")


def _k1_bound(record: dict, shape) -> None:
    """The corner kernel reads the image once and writes the map once."""
    n = int(np.prod(shape))
    _bound(record, 2 * n * 4, n * K1_FLOP_PER_PIXEL)


def _k2_bound(record: dict, img_shape, corners_shape, size: int) -> None:
    """The gather writes every patch once and reads the pixels it gathers
    once, at most the whole image, plus the corners; it computes nothing."""
    n_out = int(np.prod(corners_shape[:-1])) * size * size
    n_img = int(np.prod(img_shape))
    _bound(record, (n_out + min(n_out, n_img)) * 4 + int(np.prod(corners_shape)) * 4, 0)


def _pair_bound(record: dict, img_shape, k: int) -> None:
    """The pair writes both patch sets once, reads from each of the two
    levels the pixels it gathers, at most the whole level, and reads both
    corner sets; it computes nothing."""
    lanes = int(np.prod(img_shape[:-2]))
    n_img = int(np.prod(img_shape))
    n_t = lanes * k * LK_TSIZE * LK_TSIZE
    n_s = lanes * k * LK_SSIZE * LK_SSIZE
    n_cor = 2 * lanes * k * 2
    _bound(record, (n_t + n_s + min(n_t, n_img) + min(n_s, n_img) + n_cor) * 4, 0)


def phase_k1(dev, record: dict) -> None:
    _k1_parity(dev, record, "k1", [(shape, m) for shape in K1_SHAPES for m in K1_MODES]
               + [((3, 96, 200), K1_MODES[0])], (480, 640))


def phase_k1b(dev, record: dict) -> None:
    shape = (MULTISEQ_LANES, 480, 640)
    _k1_parity(dev, record, "k1b", [(shape, m) for m in K1_MODES], shape)


def _k1_launch_shape(dev, tag: str, record: dict, shape, patch: int, r: int) -> None:
    """Blocks an SM (from the occupancy API), grid and waves of the corner
    kernel's launch at `shape`."""
    from vo_tpu_torch.ops import kernels

    info = kernels.corner_nms_launch_info(patch, r, dev)
    lanes = int(np.prod(shape[:-2]))
    grid = (-(-shape[-1] // info["tile_w"]), -(-shape[-2] // info["tile_h"]), lanes)
    blocks = grid[0] * grid[1] * grid[2]
    resident = info["blocks_per_sm"] * info["sms"]
    record.update(grid=list(grid), blocks_per_sm=info["blocks_per_sm"],
                  smem_bytes=info["smem_bytes"], waves=blocks / resident)
    print(f"[{tag}] patch {patch} r {r}: {'specialised' if info['specialised'] else 'generic'} "
          f"instance, tile {info['tile_w']}x{info['tile_h']}, {info['threads']} threads and "
          f"{info['smem_bytes']} B of shared memory a block, {info['blocks_per_sm']} "
          f"block(s) an SM on {info['sms']} SMs; grid {grid} = {blocks} blocks = "
          f"{blocks / resident:.2f} waves")


def _k1_parity(dev, record: dict, tag: str, cases, timed_shape) -> None:
    import torch
    from vo_tpu_torch.ops import kernels

    rng = np.random.default_rng(2023)
    worst = 0.0
    for shape, (mode, patch, r) in cases:
        img = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32), device=dev)
        got = kernels.corner_response_nms(img, mode, patch, 0.08, r, use_kernel=True)
        want = kernels.corner_response_nms_plain(img, mode, patch, 0.08, r)
        torch.cuda.synchronize()
        fg, fw = torch.isfinite(got), torch.isfinite(want)
        if not torch.equal(fg, fw):
            raise AssertionError(
                f"K1 {mode} {shape}: finite masks differ at {int((fg != fw).sum())} px")
        if bool(fw.any()):
            diff = (got[fw] - want[fw]).abs()
            err = float(diff.max())
            if not bool((diff <= 1e-2 + 1e-5 * want[fw].abs()).all()):
                raise AssertionError(f"K1 {mode} {shape}: max abs err {err}")
            worst = max(worst, err)
        print(f"[{tag}] {mode:10s} shape={shape} maxima={int(fw.sum())} "
              f"max_abs_err={float(diff.max()) if bool(fw.any()) else 0.0:.3g} ok")
    img = torch.as_tensor(rng.uniform(0, 255, timed_shape).astype(np.float32), device=dev)

    def launch(mode="shi_tomasi", patch=7, r=8):
        return kernels.corner_response_nms(img, mode, patch, 0.08, r, use_kernel=True)

    _k1_launch_shape(dev, tag, record, timed_shape, 7, 8)
    ms, plain_ms = _interleaved(
        lambda: kernels.corner_response_nms_plain(img, "shi_tomasi", 7, 0.08, 8), launch)
    device_ms = _device_ms(launch)
    # No single PyTorch call computes this function: library_ms stays null.
    record.update(max_abs_err=worst, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                  library_ms=None)
    _k1_bound(record, timed_shape)
    print(f"[{tag}] {timed_shape} shi_tomasi p7 r8: kernel {ms:.4f} ms, on the device "
          f"{device_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {record['bound_ms']:.5f} ms "
          f"({record['bound_by']})")
    # The other specialised instances and the generic one, device time only.
    for mode, patch, r in K1_MODES[1:]:
        t = _device_ms(lambda: launch(mode, patch, r))
        print(f"[{tag}] {timed_shape} {mode} p{patch} r{r}: on the device {t:.4f} ms")


def _k2_case(dev, rng, tag: str, img_shape, k: int, size: int, margin: int, timed: bool):
    """Kernel against plain, bit-identical, on corners across the level and
    beyond its edges (negative and clamped starts). Returns (kernel_ms,
    plain_ms) when timed."""
    import torch
    from vo_tpu_torch.ops import kernels

    h, w = img_shape[-2:]
    lead = tuple(img_shape[:-2])
    img = torch.as_tensor(rng.uniform(0, 255, img_shape).astype(np.float32), device=dev)
    cor_np = np.stack([rng.integers(-margin, w + margin, lead + (k,)),
                       rng.integers(-margin, h + margin, lead + (k,))], -1)
    cor = torch.as_tensor(cor_np.astype(np.int32), device=dev)
    got = kernels.extract_patches(img, cor, size, use_kernel=True)
    want = kernels.extract_patches_plain(img, cor, size)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{tag} {img_shape} size {size}: not bit-identical")
    if not timed:
        print(f"[{tag}] K={k} size={size} on {img_shape}: bit-identical")
        return None
    times = _interleaved(
        lambda: kernels.extract_patches_plain(img, cor, size),
        lambda: kernels.extract_patches(img, cor, size, use_kernel=True),
    )
    print(f"[{tag}] K={k} size={size} on {img_shape}: bit-identical; kernel "
          f"{times[0]:.4f} ms, plain {times[1]:.4f} ms")
    return times


def _k2_single(record: dict, times, device_ms: float, img_shape, corners_shape,
               size: int) -> None:
    """One gather alone (extract_patches): its plain version is itself ONE
    advanced-indexing call of PyTorch, so that time is also the library's."""
    single = dict(size=size, ms=times[0], device_ms=device_ms, plain_ms=times[1],
                  library_ms=times[1])
    _k2_bound(single, img_shape, corners_shape, size)
    record["single_gather"] = single


def _pair_case(dev, rng, tag: str, img_shape, k: int, timed: bool):
    """extract_patch_pairs against its plain version (pad + two plain
    gathers), bit-identical: LK-like corners (window centres inside the
    level), the level's own corners and edges, and corners far outside the
    padded extent. Returns (ms, device_ms, plain_ms, two_launch_ms,
    two_launch_device_ms) when timed."""
    import torch
    from vo_tpu_torch.ops import kernels

    h, w = img_shape[-2:]
    lead = tuple(img_shape[:-2])
    pad, hp, wp = LK_PAD, h + 2 * LK_PAD, w + 2 * LK_PAD
    prev = torch.as_tensor(rng.uniform(0, 255, img_shape).astype(np.float32), device=dev)
    nxt = torch.as_tensor(rng.uniform(0, 255, img_shape).astype(np.float32), device=dev)

    def corners(size: int):
        half = LK_CORNER_OFFSET[size]
        # Centres anywhere in the level (the LK caller's case) ...
        cor = np.stack([rng.integers(0, w, lead + (k,)) + pad - half,
                        rng.integers(0, h, lead + (k,)) + pad - half], -1)
        # ... a quarter of them anywhere, out to 60 px beyond the padded extent,
        far = np.stack([rng.integers(-60, wp + 60, lead + (k // 4,)),
                        rng.integers(-60, hp + 60, lead + (k // 4,))], -1)
        cor[..., : k // 4, :] = far
        # ... and the extremes: centres on the level's corners, the padded
        # extent's corners, one past them, and a negative start.
        cor[..., -8:, :] = [
            [pad - half, pad - half], [pad + w - 1 - half, pad + h - 1 - half],
            [pad - half, pad + h - 1 - half], [pad + w - 1 - half, pad - half],
            [0, 0], [wp - size, hp - size], [wp, hp], [-1, -1]]
        return torch.as_tensor(cor.astype(np.int32), device=dev)

    tcor, scor = corners(LK_TSIZE), corners(LK_SSIZE)

    def pair():
        return kernels.extract_patch_pairs(prev, nxt, tcor, scor, LK_TSIZE, LK_SSIZE, pad,
                                           use_kernel=True)

    def plain():
        return kernels.extract_patch_pairs_plain(prev, nxt, tcor, scor, LK_TSIZE, LK_SSIZE,
                                                 pad)

    got, want = pair(), plain()
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{tag} pair on {img_shape}: not bit-identical")
    if not timed:
        print(f"[{tag}] pair K={k} on {img_shape}: bit-identical")
        return None
    # The way of two launches: the levels padded once outside the timing, one
    # single gather each (what a level cost before the pair, minus the pads).
    prev_p, nxt_p = kernels.pad_replicate(prev, pad), kernels.pad_replicate(nxt, pad)

    def two_launches():
        return (kernels.extract_patches(prev_p, tcor, LK_TSIZE, use_kernel=True),
                kernels.extract_patches(nxt_p, scor, LK_SSIZE, use_kernel=True))

    two = two_launches()
    if not (torch.equal(two[0], want[0]) and torch.equal(two[1], want[1])):
        raise AssertionError(f"{tag} two single gathers on {img_shape}: not bit-identical")
    ms, plain_ms = _interleaved(plain, pair)
    two_ms = _time_ms(two_launches)
    device_ms, two_device_ms = _device_ms(pair), _device_ms(two_launches)
    print(f"[{tag}] pair K={k} on {img_shape}: bit-identical; one launch {ms:.4f} ms, on the "
          f"device {device_ms:.4f} ms; two single launches (levels already padded) "
          f"{two_ms:.4f} ms, on the device {two_device_ms:.4f} ms; plain (pad + two gathers) "
          f"{plain_ms:.4f} ms")
    return ms, device_ms, plain_ms, two_ms, two_device_ms


def _pair_record(record: dict, times, img_shape, k: int) -> None:
    # No single PyTorch call pads two levels and gathers from both:
    # library_ms stays null (the single gather's is under "single_gather").
    record.update(max_abs_err=0.0, ms=times[0], device_ms=times[1], plain_ms=times[2],
                  library_ms=None, two_launch_ms=times[3], two_launch_device_ms=times[4])
    _pair_bound(record, img_shape, k)
    print(f"[pair] {img_shape} K={k}: bound {record['bound_ms']:.5f} ms ({record['bound_by']})")


def phase_k2(dev, record: dict) -> None:
    import torch
    from vo_tpu_torch.ops import kernels

    rng = np.random.default_rng(7)
    shape, k = (516, 676), 1024
    times = {size: _k2_case(dev, rng, "k2", shape, k, size, 40, True) for size in (21, 35)}
    _k2_case(dev, rng, "k2", (3, 104, 384), 70, 17, 20, False)
    img = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32), device=dev)
    cor = torch.as_tensor(rng.integers(0, 480, (k, 2)).astype(np.int32), device=dev)
    dms = _device_ms(lambda: kernels.extract_patches(img, cor, 35, use_kernel=True))
    _k2_single(record, times[35], dms, shape, (k, 2), 35)
    # What the path launches: the pair, once per pyramid level.
    timed = [_pair_case(dev, rng, "k2", lvl, k, lvl == LK_LEVEL_SHAPES[0])
             for lvl in LK_LEVEL_SHAPES]
    _pair_case(dev, rng, "k2", (3, 50, 70), 64, False)
    _pair_record(record, timed[0], LK_LEVEL_SHAPES[0], k)


def phase_k2b(dev, record: dict) -> None:
    import torch
    from vo_tpu_torch.ops import kernels

    rng = np.random.default_rng(11)
    b, k = MULTISEQ_LANES, MULTISEQ_CAPACITY
    shape = (b, 516, 676)  # level 0 of 480x640 with the LK pad of 18
    times = {size: _k2_case(dev, rng, "k2b", shape, k, size, 40, True) for size in (21, 35)}
    for size in (21, 35):  # the coarsest of the 4 levels, 60x80 + 2*18
        _k2_case(dev, rng, "k2b", (b, 96, 116), k, size, 40, True)
    img = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32), device=dev)
    cor = torch.as_tensor(rng.integers(0, 480, (b, k, 2)).astype(np.int32), device=dev)
    dms = _device_ms(lambda: kernels.extract_patches(img, cor, 35, use_kernel=True))
    _k2_single(record, times[35], dms, shape, (b, k, 2), 35)
    timed = [_pair_case(dev, rng, "k2b", (b,) + lvl, k,
                        lvl in (LK_LEVEL_SHAPES[0], LK_LEVEL_SHAPES[-1]))
             for lvl in LK_LEVEL_SHAPES]
    _pair_record(record, timed[0], (b,) + LK_LEVEL_SHAPES[0], k)


def phase_headline(dev, n_frames: int, records: dict) -> None:
    import torch
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses, rpe
    from vo_tpu_torch.models.pipeline import bootstrap, vo_step
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.utils.config import VOConfig

    cfg = VOConfig(capacity=1024)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    seq = synthetic.headline_sequence(dev, n_frames)
    spec = seq.spec
    torch.cuda.synchronize()
    print(f"[headline] rendered {tuple(seq.frames.shape)} on the device in "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(2023)
    t0 = time.perf_counter()
    state, out0 = bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg, gen)
    torch.cuda.synchronize()
    t_boot = time.perf_counter() - t0
    outs = []
    t0 = time.perf_counter()
    for i in range(3, n_frames):
        state, out = vo_step(state, seq.frames[i], seq.K, cfg)
        outs.append(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    steps = len(outs)

    poses = np.concatenate([
        np.stack([np.eye(4, dtype=np.float32), out0.pose.cpu().numpy()]),
        torch.stack([o.pose for o in outs]).cpu().numpy(),
    ])
    pose_ok = int(torch.stack([o.pose_ok for o in outs]).sum())
    frozen = int(torch.stack([o.frozen for o in outs]).sum())
    finite = int(np.isfinite(poses[2:]).all(axis=(1, 2)).sum())
    gt = seq.gt_poses[[0, 2] + list(range(3, n_frames))]
    ate = ate_rmse(positions_from_poses(poses), positions_from_poses(gt))
    t_rpe, r_rpe = rpe(poses, gt)
    fps = steps / dt
    print(f"[headline] bootstrap {t_boot:.2f} s (pose_ok={bool(out0.pose_ok)}, "
          f"{int(out0.num_triangulated)} landmarks)")
    print(f"[headline] {steps} vo_steps in {dt:.2f} s = {fps:.2f} frames/s")
    print(f"[headline] ATE {ate:.4f} m (reference {REFERENCE_ATE_M} m, drift "
          f"{100.0 * (ate - REFERENCE_ATE_M) / REFERENCE_ATE_M:+.1f}%), "
          f"RPE {t_rpe:.5f} m / {np.degrees(r_rpe):.5f} deg")
    print(f"[headline] pose_ok {pose_ok}/{steps}, finite {finite}/{steps}, frozen {frozen}")
    print(f"[headline] launches: {json.dumps(counts)}")
    records["corner_response_nms"]["launches"] = counts["corner_response_nms"]
    records["extract_patches"]["launches"] = counts["extract_patches"]
    HANDOFF["ba_window"] = (state.window, seq.K)

    # The renderer against the reference numpy renderer on two frames.
    rects, tex = synthetic.scene(spec)
    for i in (0, n_frames // 2):
        ref = synthetic.render_frame(rects, tex, seq.gt_poses[i], spec.K(),
                                     spec.width, spec.height, dist=spec.dist)
        d = np.abs(seq.frames[i].cpu().numpy() - ref.astype(np.float32)).max()
        print(f"[headline] frame {i}: device render vs numpy max diff {d:.0f} grey levels")
        if d > 2:
            raise AssertionError(f"renderer disagrees with the reference at frame {i}: {d}")

    fails = []
    if counts["corner_response_nms"] != steps + 1:
        fails.append(f"K1 launched {counts['corner_response_nms']} times, want {steps + 1}")
    # One launch per pyramid level does both gathers of the level.
    want_k2 = cfg.klt.pyramid_levels * (steps + 1)
    if counts["extract_patches"] != want_k2:
        fails.append(f"K2 launched {counts['extract_patches']} times, want {want_k2}")
    if finite != steps or frozen:
        fails.append(f"{steps - finite} non-finite poses, {frozen} frozen frames")
    if pose_ok < steps - POSE_OK_SLACK:
        fails.append(f"pose_ok on {pose_ok}/{steps} frames, want >= {steps - POSE_OK_SLACK}")
    if not ate <= ATE_GATE_M:
        fails.append(f"ATE {ate:.4f} m above the {ATE_GATE_M} m gate")
    if fails:
        raise AssertionError("; ".join(fails))


def phase_multiseq(dev, n_frames: int, records: dict) -> None:
    """The lockstep multi-sequence evaluation through the functions that
    `run_multiseq_torch.py --full` runs."""
    import dataclasses

    import torch

    import run_multiseq_torch as runner
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.utils.config import VOConfig

    cfg = VOConfig(capacity=MULTISEQ_CAPACITY)
    levels = cfg.klt.pyramid_levels
    full = n_frames == 600
    fails = []

    t0 = time.perf_counter()
    seqs = synthetic.multiseq_sequences(dev, n_frames)
    torch.cuda.synchronize()
    names = list(seqs)
    b = len(names)
    print(f"[multiseq] rendered {b} lanes of {tuple(seqs[names[0]].frames.shape)} on the "
          f"device in {time.perf_counter() - t0:.1f} s")
    if b != MULTISEQ_LANES:
        fails.append(f"{b} lanes, want {MULTISEQ_LANES}")

    # The six lanes: bootstrapped alone, stacked, rolled in lockstep.
    kernels.reset_launch_counts()
    boot, outs, dt = runner.run_lockstep(seqs, cfg, adaptive=synthetic.ADAPTIVE_LANES)
    counts = dict(kernels.launch_counts)
    poses = outs.pose.cpu().numpy()  # (N, B, 4, 4)
    steps = poses.shape[0]
    pose_ok = outs.pose_ok.sum(dim=0).tolist()
    frozen = outs.frozen.sum(dim=0).tolist()
    print(f"[multiseq] {steps} lockstep steps of {b} lanes in {dt:.2f} s = "
          f"{1e3 * dt / steps:.1f} ms a step, {b * steps / dt:.2f} frames/s aggregate, "
          f"{steps / dt:.2f} frames/s a lane")
    print(f"[multiseq] launches (bootstraps + rollout): {json.dumps(counts)}")
    want = {
        "corner_response_nms": b, "extract_patches": levels * b,
        "corner_response_nms_batched": steps,
        "extract_patches_batched": levels * steps,
    }
    if counts != want:
        fails.append(f"launches {counts}, want {want}")
    records["corner_response_nms_batched"]["launches"] = counts["corner_response_nms_batched"]
    records["extract_patches_batched"]["launches"] = counts["extract_patches_batched"]

    def judge(name, est, gt, n_ok, n_frozen, n_steps):
        from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses, rpe

        finite = int(np.isfinite(est[2:]).all(axis=(1, 2)).sum())
        ate = ate_rmse(positions_from_poses(est), positions_from_poses(gt))
        t_rpe, r_rpe = rpe(est, gt)
        ref = MULTISEQ_REFERENCE_ATE_M[name]
        gate = max(MULTISEQ_ATE_FACTOR * ref, MULTISEQ_ATE_FLOOR_M)
        print(f"[multiseq] lane {name:9s} ATE {ate:.4f} m (yardstick {ref} m, gate "
              f"{gate:.2f} m), RPE {t_rpe:.5f} m / {np.degrees(r_rpe):.5f} deg, pose_ok "
              f"{n_ok}/{n_steps}, finite {finite}/{n_steps}, frozen {n_frozen}")
        if finite != n_steps or n_frozen:
            fails.append(f"{name}: {n_steps - finite} non-finite poses, {n_frozen} frozen")
        if n_ok < int(np.ceil(MULTISEQ_POSE_OK_SHARE * n_steps)):
            fails.append(f"{name}: pose_ok on {n_ok}/{n_steps} frames, want >= "
                         f"{int(np.ceil(MULTISEQ_POSE_OK_SHARE * n_steps))}")
        if full and not ate <= gate:
            fails.append(f"{name}: ATE {ate:.4f} m above its {gate:.2f} m gate")

    for i, name in enumerate(names):
        gt = seqs[name].gt_poses[[0, 2] + list(range(3, 3 + steps))]
        judge(name, runner.lane_poses(boot[i], poses[:, i]), gt, pose_ok[i], frozen[i], steps)
    del seqs, outs
    torch.cuda.empty_cache()

    # The distorted-lens lane on its own (distortion is static in the config).
    dseq = synthetic.render_sequence(synthetic.distorted_spec(n_frames), dev)
    dcfg = dataclasses.replace(cfg, dist=synthetic.DISTORTED_DIST)
    kernels.reset_launch_counts()
    dboot, douts, ddt = runner.run_single(dseq, dcfg, seed=2030)
    dcounts = dict(kernels.launch_counts)
    dsteps = douts.pose.shape[0]
    print(f"[multiseq] distorted lane: {dsteps} steps in {ddt:.2f} s = "
          f"{dsteps / ddt:.2f} frames/s; launches {json.dumps(dcounts)}")
    dwant = {
        "corner_response_nms": dsteps + 1, "extract_patches": levels * (dsteps + 1),
        "corner_response_nms_batched": 0, "extract_patches_batched": 0,
    }
    if dcounts != dwant:
        fails.append(f"distorted lane launches {dcounts}, want {dwant}")
    dgt = dseq.gt_poses[[0, 2] + list(range(3, 3 + dsteps))]
    judge("distorted", runner.lane_poses(dboot, douts.pose.cpu().numpy()), dgt,
          int(douts.pose_ok.sum()), int(douts.frozen.sum()), dsteps)
    records["corner_response_nms"]["launches_multiseq"] = (
        counts["corner_response_nms"] + dcounts["corner_response_nms"])
    records["extract_patches"]["launches_multiseq"] = (
        counts["extract_patches"] + dcounts["extract_patches"])
    if fails:
        raise AssertionError("; ".join(fails))


def _drive(argv, observer=None):
    """One run of the `run_vo_torch.py` entry point, through its own `run`."""
    import run_vo_torch

    rc, done = run_vo_torch.run(run_vo_torch.parse_args(argv), observer)
    if rc != 0 or done is None:
        raise AssertionError(f"run_vo_torch {' '.join(argv)} exited {rc}")
    return done


def _run_gates(tag: str, done, fails: list, share: float = RUN_POSE_OK_SHARE) -> dict:
    """Finiteness, frozen frames and the pose_ok share of one run."""
    steps = len(done.stats)
    est = done.poses_raw if done.poses_raw is not None else done.poses
    finite = int(np.isfinite(est[2:]).all(axis=(1, 2)).sum())
    n_ok = sum(1 for s in done.stats if s["ok"])
    frozen = sum(1 for s in done.stats if s["frozen"])
    want_ok = int(np.ceil(share * steps))
    if finite != steps or frozen:
        fails.append(f"{tag}: {steps - finite} non-finite poses, {frozen} frozen frames")
    if n_ok < want_ok:
        fails.append(f"{tag}: pose_ok on {n_ok}/{steps} frames, want >= {want_ok}")
    return dict(steps=steps, pose_ok=n_ok, finite=finite, frozen=frozen)


def _free() -> None:
    """Hand the device memory of the runs just dropped back to the card."""
    import torch

    torch.cuda.empty_cache()


def phase_harris(dev, n_frames: int, records: dict) -> None:
    """`run_vo_torch.py --tracker harris`: Harris detection through the
    corner kernel's (harris, 7, 5) instance, matched-patch tracking."""
    from vo_tpu_torch.ops import kernels

    fails = []
    kernels.reset_launch_counts()
    done = _drive(["--tracker", "harris", "--chunk", "16", "--quiet",
                   "--max-frames", str(n_frames)])
    counts = dict(kernels.launch_counts)
    line = dict(phase="harris", **_run_gates("harris", done, fails, HARRIS_POSE_OK_SHARE),
                **done.result, launches=counts)
    steps = line["steps"]
    want = {"corner_response_nms": 2 + steps, "extract_patches": 0,
            "corner_response_nms_batched": 0, "extract_patches_batched": 0}
    if counts != want:
        fails.append(f"launches {counts}, want {want}")
    ate = done.result.get("ate_rmse_m", np.inf)
    line.update(ate_yardstick_m=HARRIS_REFERENCE_ATE_M,
                ate_within_twice_yardstick=bool(ate <= 2.0 * HARRIS_REFERENCE_ATE_M),
                ate_limit_m=HARRIS_ATE_LIMIT_M)
    if n_frames == 600 and not ate <= HARRIS_ATE_LIMIT_M:
        fails.append(f"ATE {ate} m above the {HARRIS_ATE_LIMIT_M} m limit")
    records["corner_response_nms"]["launches_harris"] = counts["corner_response_nms"]
    records["extract_patches"]["launches_harris"] = counts["extract_patches"]

    # The first frames again: a seeded run reproduces bit for bit.
    n_rep = min(REPEAT_FRAMES, n_frames)
    again = _drive(["--tracker", "harris", "--chunk", "16", "--quiet",
                    "--max-frames", str(n_rep)])
    first = done.poses[:len(again.poses)]
    line["repeat_bit_equal"] = bool(np.array_equal(again.poses, first))
    if not line["repeat_bit_equal"]:
        d = np.abs(again.poses - first).max()
        fails.append(f"the first {n_rep} frames run again differ (max {d:.3g})")
    print(json.dumps(line))
    del done, again
    _free()
    if fails:
        raise AssertionError("; ".join(fails))


def phase_sift(dev, n_frames: int, records: dict) -> None:
    """`run_vo_torch.py --tracker sift`: DoG detection, 128-D descriptors,
    matched tracking; no hand-written kernel lies on this path."""
    from vo_tpu_torch.ops import kernels

    fails = []
    kernels.reset_launch_counts()
    done = _drive(["--tracker", "sift", "--chunk", "16", "--quiet",
                   "--max-frames", str(n_frames)])
    counts = dict(kernels.launch_counts)
    line = dict(phase="sift", **_run_gates("sift", done, fails),
                **done.result, launches=counts)
    if any(counts.values()):
        fails.append(f"launches {counts}, want none")
    if n_frames in SIFT_REFERENCE_ATE_M:
        ref = SIFT_REFERENCE_ATE_M[n_frames]
        gate = max(2.0 * ref, SIFT_ATE_FLOOR_M_PER_FRAME * n_frames)
        line.update(ate_yardstick_m=ref, ate_gate_m=gate)
        if not done.result.get("ate_rmse_m", np.inf) <= gate:
            fails.append(f"ATE {done.result.get('ate_rmse_m')} m above the {gate:.3f} m gate")
    records["corner_response_nms"]["launches_sift"] = counts["corner_response_nms"]
    records["extract_patches"]["launches_sift"] = counts["extract_patches"]
    print(json.dumps(line))
    del done
    _free()
    if fails:
        raise AssertionError("; ".join(fails))


def phase_loop(dev, n_frames: int, records: dict) -> None:
    """`run_vo_torch.py --spec loop --pose-graph --chunk 16` over the closed
    circuit, then the resume of its mid-run checkpoint against the straight
    run, bit for bit."""
    import tempfile

    import torch

    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.utils.config import VOConfig

    fails = []
    full = n_frames == LOOP_FRAMES
    levels = VOConfig().klt.pyramid_levels
    base = ["--spec", "loop", "--pose-graph", "--chunk", "16", "--quiet"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "loop.npz")
        seen = {}

        def observer(frame, state, backend):
            # The frame whose checkpoint is on disk, then the state one chunk on.
            if "ckpt_frame" not in seen:
                if Path(ckpt).exists():
                    seen["ckpt_frame"] = frame
            elif "table" not in seen and frame >= seen["ckpt_frame"] + 16:
                seen["frame"] = frame
                seen["table"] = [f.clone() for f in state.table]
                seen["graph"] = [f.clone() for f in backend.graph]

        # One checkpoint in the run, about half way.
        every = LOOP_CHECKPOINT_EVERY if full else (n_frames + 1) // 2
        kernels.reset_launch_counts()
        done = _drive(base + ["--max-frames", str(n_frames), "--checkpoint", ckpt,
                              "--checkpoint-every", str(every)], observer)
        counts = dict(kernels.launch_counts)
        res = done.result
        line = dict(phase="loop", **_run_gates("loop", done, fails),
                    **res, launches=counts,
                    loops=done.backend.loops, rejected=len(done.backend.rejected))
        steps = line["steps"]
        want = {"corner_response_nms": 1 + steps, "extract_patches": levels * (1 + steps),
                "corner_response_nms_batched": 0, "extract_patches_batched": 0}
        if counts != want:
            fails.append(f"launches {counts}, want {want}")
        records["corner_response_nms"]["launches_loop"] = counts["corner_response_nms"]
        records["extract_patches"]["launches_loop"] = counts["extract_patches"]
        # The graph as the run built it, before its final optimization.
        HANDOFF["pose_graph"] = (
            done.backend.graph._replace(node_pose=done.backend._pre_opt_pose),
            done.backend.graph.node_pose, done.backend.cfg)
        if full:
            raw, ate = res.get("ate_rmse_m_pre_pg", np.inf), res.get("ate_rmse_m", np.inf)
            if res.get("pg_nodes", 0) < LOOP_MIN_NODES:
                fails.append(f"pg_nodes {res.get('pg_nodes')}, want >= {LOOP_MIN_NODES}")
            if res.get("pg_loops", 0) < LOOP_MIN_LOOPS:
                fails.append(f"pg_loops {res.get('pg_loops')}, want >= {LOOP_MIN_LOOPS}")
            if not raw <= 2.0 * LOOP_REFERENCE_RAW_ATE_M:
                fails.append(f"raw ATE {raw} m above {2.0 * LOOP_REFERENCE_RAW_ATE_M} m")
            if not (ate <= 1.1 * raw and ate <= 2.0 * LOOP_REFERENCE_PG_ATE_M):
                fails.append(f"corrected ATE {ate} m above 1.1 x raw {raw} m or "
                             f"{2.0 * LOOP_REFERENCE_PG_ATE_M} m")

        # Resume the checkpoint for one chunk: poses, table and graph equal
        # the straight run's at that frame, bit for bit.
        if "table" not in seen:
            fails.append("no checkpoint with a chunk after it was seen in the run")
        else:
            upto = seen["frame"]
            back = _drive(base + ["--resume", ckpt, "--max-frames", str(upto + 1)])
            n_rows = done.frame_ids.index(upto) + 1
            same_ids = back.frame_ids == done.frame_ids[:n_rows]
            same_poses = same_ids and np.array_equal(back.poses_raw, done.poses_raw[:n_rows])
            same_table = all(torch.equal(a, b) for a, b in zip(back.state.table, seen["table"]))
            # `run` optimizes the graph at its end: the node poses as they
            # were before that are the back-end's `_pre_opt_pose`.
            got_graph = back.backend.graph._replace(node_pose=back.backend._pre_opt_pose)
            same_graph = all(torch.equal(a, b) for a, b in zip(got_graph, seen["graph"]))
            line.update(resume=dict(checkpoint_frame=seen["ckpt_frame"], compared_at=upto,
                                    poses=bool(same_poses), table=bool(same_table),
                                    graph=bool(same_graph)))
            if not (same_poses and same_table and same_graph):
                fails.append(f"resume from frame {seen['ckpt_frame']} differs from the straight "
                             f"run at frame {upto}: {line['resume']}")
            del back
    print(json.dumps(line))
    del done
    _free()
    if fails:
        raise AssertionError("; ".join(fails))


def _timed(fn, *a, **k):
    """(fn's result, seconds on the host clock with the card synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _max_diff(a, b) -> float:
    """Largest |a - b| over tensors or tuples of them (NaN equal to NaN)."""
    import torch

    if isinstance(a, tuple):
        return max(_max_diff(x, y) for x, y in zip(a, b))
    if not a.dtype.is_floating_point:
        return float((a != b).sum())
    d = (a - b).abs()
    return float(torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d).max())


def _dist_line(part: str, backend: str, dev, world: int, **fields) -> dict:
    line = dict(phase="dist", part=part, world_size=world, backend=backend,
                device=str(dev), **fields)
    print(json.dumps(line))
    return line


def _dist_one_rank(dev, fails: list) -> None:
    """(a) The four sharded solvers in a real single-rank NCCL group on the
    card, at full width, against their single-device functions."""
    import torch
    import torch.distributed as dist

    from vo_tpu_torch.geom.lie import se3_exp
    from vo_tpu_torch.models.ba import ba_refine
    from vo_tpu_torch.models.pose_graph import pg_optimize
    from vo_tpu_torch.ops.pnp import refine_pose_gn
    from vo_tpu_torch.parallel import (
        demo_window,
        distributed_ba_refine,
        distributed_pg_optimize,
        distributed_refine_pose,
        make_mesh,
        seqpar_ba_refine,
        shard_window,
        shard_window_blocks,
    )
    from vo_tpu_torch.parallel.mesh import psum
    from vo_tpu_torch.parallel.window_blocks import gather_window_blocks

    mesh = make_mesh(n_data=1, n_model=1, device=dev)
    backend = dist.get_backend()
    try:
        # NCCL sets its communicator up at the first collective: not a
        # solver's time.
        _timed(psum, torch.zeros(1, device=dev), mesh, "model")
        if backend != "nccl":
            fails.append(f"one rank on the card runs {backend}, want nccl")

        # dist_gn: 1,024 observations of a planted pose, 0.5 px noise.
        rng = np.random.default_rng(5)
        n = DIST_GN_POINTS
        K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], device=dev)
        T_true = se3_exp(torch.tensor([0.3, -0.1, 0.2, 0.05, -0.08, 0.1], device=dev))
        X = torch.tensor(rng.uniform([-5, -3, 8], [5, 3, 30], (n, 3)), dtype=torch.float32,
                         device=dev)
        Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
        uv = (Xc @ K.T)[:, :2] / Xc[:, 2:]
        uv = uv + torch.tensor(rng.normal(0, 0.5, (n, 2)), dtype=torch.float32, device=dev)
        T0 = se3_exp(torch.tensor(rng.normal(0, 0.03, 6), dtype=torch.float32,
                                  device=dev)) @ T_true
        w = torch.ones(n, device=dev)
        got, t_dist = _timed(distributed_refine_pose, mesh, T0, X, uv, w, K, iters=8)
        want, t_one = _timed(refine_pose_gn, T0, X, uv, K, w, iters=8)
        line = _dist_line("dist_gn", backend, dev, 1, observations=n,
                          max_abs_diff=_max_diff(got, want), bit_equal=bool(torch.equal(got, want)),
                          pose_err_vs_truth=_max_diff(got, T_true),
                          seconds=round(t_dist, 4), single_device_seconds=round(t_one, 4))
        if not line["bit_equal"]:
            fails.append(f"dist_gn at one rank differs from refine_pose_gn by "
                         f"{line['max_abs_diff']}")

        # dist_ba: the headline's last BA window (W=6, L=1,024).
        if "ba_window" not in HANDOFF:
            fails.append("dist_ba: no window from the headline phase")
        else:
            win, Kh = HANDOFF["ba_window"]
            (out, errs), t_dist = _timed(distributed_ba_refine, mesh, shard_window(win, mesh), Kh)
            (ref, ref_errs), t_one = _timed(ba_refine, win, Kh)
            line = _dist_line(
                "dist_ba", backend, dev, 1, window=list(win.obs_mask.shape[::-1]),
                valid_landmarks=int(win.lm_valid.sum()), err_first=float(ref_errs[0]),
                err_last=float(ref_errs[-1]), max_abs_diff=_max_diff(tuple(out), tuple(ref)),
                bit_equal=bool(all(torch.equal(a, b) for a, b in zip(out, ref))
                               and torch.equal(errs, ref_errs)),
                seconds=round(t_dist, 4), single_device_seconds=round(t_one, 4))
            if not line["bit_equal"]:
                fails.append(f"dist_ba at one rank differs from ba_refine by "
                             f"{line['max_abs_diff']}")

        # dist_pg: the loop circuit's pose graph before its final optimization.
        if "pose_graph" not in HANDOFF:
            fails.append("dist_pg: no graph from the loop phase")
        else:
            graph, run_pose, bcfg = HANDOFF["pose_graph"]
            kw = dict(iters=bcfg.pg_iters, damping=bcfg.pg_damping)
            (out, errs), t_dist = _timed(distributed_pg_optimize, mesh, graph, **kw)
            (ref, ref_errs), t_one = _timed(pg_optimize, graph, **kw)
            line = _dist_line(
                "dist_pg", backend, dev, 1, capacity=graph.capacity,
                nodes=int(graph.node_valid.sum()), loop_edges=int(graph.loop_valid.sum()),
                err_first=float(ref_errs[0]), err_last=float(ref_errs[-1]),
                max_abs_diff=_max_diff(out.node_pose, ref.node_pose),
                bit_equal=bool(torch.equal(out.node_pose, ref.node_pose)
                               and torch.equal(errs, ref_errs)),
                equals_the_run=bool(torch.equal(out.node_pose, run_pose)),
                seconds=round(t_dist, 4), single_device_seconds=round(t_one, 4))
            if not line["bit_equal"]:
                fails.append(f"dist_pg at one rank differs from pg_optimize by "
                             f"{line['max_abs_diff']}")

        # seqpar: demo_window(1024, 8) on one rank against ba_refine, at the
        # JAX package's tolerances (the blocked sums reorder additions).
        win = demo_window(DIST_SEQPAR_LANDMARKS, DIST_SEQPAR_WINDOW, device=dev)
        Kd = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], device=dev)
        (out, errs), t_dist = _timed(seqpar_ba_refine, mesh, shard_window_blocks(win, mesh), Kd)
        out = gather_window_blocks(out, mesh)
        (ref, ref_errs), t_one = _timed(ba_refine, win, Kd)
        ok = (torch.allclose(errs, ref_errs, rtol=1e-3, atol=1e-4)
              and torch.allclose(out.kf_pose, ref.kf_pose, rtol=2e-4, atol=2e-4)
              and torch.allclose(out.landmark, ref.landmark, rtol=2e-3, atol=2e-3)
              and float(ref_errs[-1]) < float(ref_errs[0]))
        _dist_line("seqpar", backend, dev, 1, window=[DIST_SEQPAR_WINDOW, DIST_SEQPAR_LANDMARKS],
                   err_first=float(ref_errs[0]), err_last=float(ref_errs[-1]),
                   max_abs_diff={"errs": _max_diff(errs, ref_errs),
                                 "pose": _max_diff(out.kf_pose, ref.kf_pose),
                                 "landmarks": _max_diff(out.landmark, ref.landmark)},
                   within_tolerance=bool(ok), seconds=round(t_dist, 4),
                   single_device_seconds=round(t_one, 4))
        if not ok:
            fails.append("seqpar at one rank outside the tolerances of tests/test_window_blocks.py")
    finally:
        dist.destroy_process_group()


def _dist_cluster(fails: list, records: dict) -> None:
    """(b) Two ranks sharing cuda:0 over Gloo (NCCL refuses two ranks on one
    card): the multihost worker's three modes."""
    from vo_tpu_torch.parallel import multihost

    gloo = ["--device", "cuda", "--backend", "gloo"]
    for mode in ("--dist-ba", "--seqpar-ba"):
        rep, dt = _timed(multihost.run_cluster, 2, [
            mode, "--ba-landmarks-per-device", str(DIST_BA_LANDMARKS_PER_RANK)] + gloo,
            timeout=DIST_CLUSTER_TIMEOUT_S)
        _dist_line(mode[2:], rep["backend"], rep["device"], rep["world_size"],
                   **{k: rep[k] for k in ("max_abs_diff", "match", "improved", "err_first",
                                          "err_last", "all_ranks_ok")},
                   seconds=round(dt, 3), rank_seconds=rep["seconds"])
        if not (all(rep["match"].values()) and rep["improved"] and rep["all_ranks_ok"]):
            fails.append(f"multihost {mode}: {rep['match']}, improved {rep['improved']}")

    steps, lanes = DIST_ROLLOUT_STEPS, DIST_ROLLOUT_LANES
    rep, dt = _timed(multihost.run_cluster, 2, [
        "--lanes-per-device", str(lanes), "--steps", str(steps), "--capacity",
        str(MULTISEQ_CAPACITY), "--crop", "480x640", "--repeats", "2"] + gloo,
        timeout=DIST_CLUSTER_TIMEOUT_S)
    launches = rep["launches"]
    _dist_line("rollout", rep["backend"], rep["device"], rep["world_size"],
               lanes_global=rep["lanes_global"], steps=steps, frame=rep["frame"],
               finite=rep["finite"], gsum_ok=rep["gsum_ok"], pose_ok=rep["pose_ok"],
               launches=launches, agg_fps=rep["agg_fps"],
               agg_fps_note="the two ranks share one card: no scaling is measured",
               seconds=round(dt, 3), rank_seconds=rep["seconds"])
    want = {"corner_response_nms": [0, 0], "extract_patches": [0, 0],
            "corner_response_nms_batched": [steps, steps],
            "extract_patches_batched": [4 * steps, 4 * steps]}
    if launches != want:
        fails.append(f"rollout launches {launches}, want {want}")
    if not (rep["finite"] and rep["gsum_ok"]):
        fails.append(f"rollout: finite {rep['finite']}, cross-rank sum {rep['gsum_ok']}")
    records["corner_response_nms_batched"]["launches_dist_rollout"] = launches[
        "corner_response_nms_batched"]
    records["extract_patches_batched"]["launches_dist_rollout"] = launches[
        "extract_patches_batched"]


def _dist_seqpar_rollout(fails: list, records: dict) -> None:
    """(c) run_multiseq_torch.py --seqpar-shards 2: rank 0's front-end
    pushes a composed 8-keyframe window, two ranks refine it."""
    import run_multiseq_torch as runner

    args = runner.parse_args(["--seqpar-shards", "2"])
    rep, dt = _timed(runner.seqpar_cluster, args)
    _dist_line("seqpar_shards", rep["backend"], rep["device"], rep["world_size"],
               frames=rep["frames"], window_effective=rep["window_effective"],
               refinements=rep["refinements"], ate_no_refine_m=rep["ate_no_refine_m"],
               ate_seqpar_m=rep["ate_seqpar_m"], finite=rep["finite"],
               yardstick=SEQPAR_YARDSTICK, launches=rep["launches"],
               seconds=round(dt, 3), rank0_seconds=rep["seconds"])
    if not rep["passed"]:
        fails.append(f"seqpar rollout: ATE {rep['ate_seqpar_m']} m with the back-end, "
                     f"{rep['ate_no_refine_m']} m without, finite {rep['finite']}")
    steps = rep["frames"] - 3
    want = {"corner_response_nms": steps + 1, "extract_patches": 4 * (steps + 1),
            "corner_response_nms_batched": 0, "extract_patches_batched": 0}
    if rep["launches"] != want:
        fails.append(f"seqpar rollout launches {rep['launches']}, want {want}")
    records["corner_response_nms"]["launches_dist_seqpar"] = rep["launches"]["corner_response_nms"]
    records["extract_patches"]["launches_dist_seqpar"] = rep["launches"]["extract_patches"]


def phase_dist(dev, records: dict) -> None:
    """The distributed layer: (a) one NCCL rank, (b) a two-rank Gloo
    cluster on the one card, (c) the sequence-parallel rollout."""
    fails = []
    t0 = time.perf_counter()
    _dist_one_rank(dev, fails)
    _dist_cluster(fails, records)
    _dist_seqpar_rollout(fails, records)
    print(f"[dist] (a) + (b) + (c) in {time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("; ".join(fails))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=600,
                        help="length of the headline sequence (default 600)")
    parser.add_argument("--multiseq-frames", type=int, default=150,
                        help="frames per lane of the multi-sequence phase (default "
                             "150, to keep the script inside its time; the ATE gates "
                             "apply only at the full length of 600)")
    parser.add_argument("--harris-frames", type=int, default=600,
                        help="frames of the harris-tracker run (default 600; the ATE "
                             "gate applies only at full length)")
    parser.add_argument("--sift-frames", type=int, default=150,
                        help="frames of the sift-tracker run (default 150; the ATE "
                             "gate applies at 150 and at 600)")
    parser.add_argument("--loop-frames", type=int, default=LOOP_FRAMES,
                        help=f"frames of the loop-closure run (default {LOOP_FRAMES}; the "
                             "graph and ATE gates apply only at full length)")
    args = parser.parse_args(argv)
    if min(args.frames, args.multiseq_frames, args.harris_frames, args.sift_frames,
           args.loop_frames) < 4:
        parser.error("every --*frames must be at least 4")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to test", file=sys.stderr)
        return 2
    try:
        import vo_tpu_torch
        from vo_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2
    # The kernels must come from this checkout's sources, not from a copy of
    # the package installed elsewhere.
    here = Path(__file__).resolve().parent
    if Path(vo_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: vo_tpu_torch was imported from {vo_tpu_torch.__file__}, "
              f"not from {here}", file=sys.stderr)
        return 2

    dev = torch.device("cuda:0")
    card = _card_line()
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    records = {
        "corner_response_nms": dict(
            name="corner_response_nms", route="cuda",
            source="vo_tpu_torch/csrc/corner_nms.cu",
            replaces="vo_tpu/ops/pallas_kernels.py:196"),
        "corner_response_nms_batched": dict(
            name="corner_response_nms_batched", route="cuda",
            source="vo_tpu_torch/csrc/corner_nms.cu",
            replaces="vo_tpu/ops/pallas_kernels.py:257"),
        "extract_patches": dict(
            name="extract_patches", route="cuda",
            source="vo_tpu_torch/csrc/patch_gather.cu",
            replaces="vo_tpu/ops/pallas_kernels.py:387"),
        "extract_patches_batched": dict(
            name="extract_patches_batched", route="cuda",
            source="vo_tpu_torch/csrc/patch_gather.cu",
            replaces="vo_tpu/ops/pallas_kernels.py:464"),
    }
    for rec in records.values():
        rec.update(launches=0, max_abs_err=None, ms=None, device_ms=None, plain_ms=None,
                   bound_ms=None, bound_by=None, library_ms=None,
                   device_ms_by="CUDA graph replay")
    failed = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            fn(*a)
            print(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
        except Exception:  # a failed phase is reported; the others still run
            failed.append(name)
            print(f"[{name}] FAILED", flush=True)
            traceback.print_exc(file=sys.stdout)

    def build():
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        print(f"[build] {lib} ready in {time.perf_counter() - t0:.1f} s")
        log = lib.parent / "build.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    print(f"[build] {line.strip()}")
        from vo_tpu_torch.ops import kernels

        floor = _time_ms(lambda: kernels.empty_launch(dev), reps=200)
        floor_dev = _device_ms(lambda: kernels.empty_launch(dev), reps=100)
        print(f"[build] an empty launch through the same ctypes path: {floor:.4f} ms from "
              f"the host (the floor under every `ms` below), {floor_dev:.4f} ms on the "
              f"device in a replayed CUDA graph (the floor under every `device_ms`)")
        for rec in records.values():
            rec.update(empty_launch_ms=floor, empty_launch_device_ms=floor_dev)

    run("build", build)
    if "build" not in failed:
        run("k1", phase_k1, dev, records["corner_response_nms"])
        run("k2", phase_k2, dev, records["extract_patches"])
        run("k1b", phase_k1b, dev, records["corner_response_nms_batched"])
        run("k2b", phase_k2b, dev, records["extract_patches_batched"])
    run("headline", phase_headline, dev, args.frames, records)
    run("multiseq", phase_multiseq, dev, args.multiseq_frames, records)
    run("harris", phase_harris, dev, args.harris_frames, records)
    run("sift", phase_sift, dev, args.sift_frames, records)
    run("loop", phase_loop, dev, args.loop_frames, records)
    run("dist", phase_dist, dev, records)

    print(f"[card] {card}")
    print(json.dumps({"kernels": list(records.values())}))
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
