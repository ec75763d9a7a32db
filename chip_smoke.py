#!/usr/bin/env python3
"""Smoke test of vo_tpu_torch on one CUDA GPU — the quickest proof that the
port builds, agrees with its plain PyTorch versions, and runs its main path.

    python3 chip_smoke.py            # every phase at full length (the tools phase cut)
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
  6b. `lk`, `lkb`: the LK solve kernel (csrc/lk_solve.cu) against its plain
     version (ops/klt.py `lk_solve_plain`) on the patches each level of a
     `pyramidal_lk_counted` call over the headline's city gathers, K=1024
     points a lane (half its strongest corners, half anywhere), one lane and
     six: G's condition, flows within 1e-3 px and errors within 1e-4 of the
     tracked points, live iterations within 0.5%; each of the four 480x640
     levels timed beside its bound (the patches read once, the outputs
     written once);
  7. `headline`: bench_torch.py's headline through its own
     `bench_synthetic_full`: the synthetic city written to disk by
     `generate` and read back through `Sequence("synthetic")`, two frames
     checked against the numpy renderer, bootstrap, then an eager warm-up
     and a timed `vo_rollout` that replays the step's CUDA graph, one a
     frame, R and C as IF nodes (vo_tpu_torch/models/graphed.py, captured
     between the two) with VOConfig(capacity=1024); gates the launch
     counts of both rollouts, every StepOutput field of the captured
     rollout bit-equal to the eager warm-up's, one graph a frame holding
     two IF nodes and no host sync in it, finiteness, the pose_ok count and
     the ATE against exact ground truth; the DLT's eigh on the card
     (ops/cusolver.py) bit-equal to torch.linalg.eigh on the headline's own
     DLT systems: each of the eager warm-up's first 16 steps runs both on
     its systems (the bootstrap state, the run's own draws); the
     bootstrap's float64 two-view solve (pipeline.two_view_f64: 8-point
     RANSAC, E, cheirality; then `bootstrap_map`) run again from its kept
     inputs and uniforms on the card and the CPU and gated: the same inlier
     masks and counts, the same landmark count, poses of camera 1 within
     1e-3 degree and 1e-3 of the baseline, both finite, the card's rerun
     the run's own solve bit for bit; prints both frames/s, the capture's seconds,
     the graphs and their nodes, the syncs a step that torch's sync
     detector reported and the frames on which R and C ran, as the device
     counted them;
  7b. `bench`: the measurement entry points. (a) K1 and the K2 pair at KITTI
     05's frame size (370x1226) and its pyramid levels against their plain
     versions, timed; (b) bench_torch's `bench_kitti_probe` over the first 6
     frames of the city rendered at 1226x370, focal 707.0912 (capacity 512,
     40 ping-ponged steps, an eager warm-up and a captured timed rollout:
     launch counts, finite, 0 frozen, the two bit-equal); (c) tools/roofline_torch.py and tools/profile_all_torch.py over
     the 640x480 city (host against device time, part by part); (d)
     tools/bench_solvers_torch.py (the solver pairs agree within 1e-4) and
     tools/bench_pg_torch.py (the error falls; one rank equals pg_optimize);
  7c. `tools`: the remaining tool twins over the headline's city. (a)
     tools/check_headline_torch.py's drift gate applied to the headline
     phase's own result (ATE within 5% of tools/headline_expected_torch.json;
     a rehearsal with fewer frames reports and does not gate); (b)
     repro_headline_torch over the first 24 frames (`--repro-frames`) with
     the kernels on, K2 off, K1 off and both off: each toggle's K1, K2 and
     LK solve launches, and with the klt kernels off (K2 and the LK solve)
     the poses of the plain solve bit for bit (REPRO_PLAIN_POSES_SHA256,
     gated at 24 frames only); (c) probe_ablate_torch's six
     variants at 1226x370, 4 steps (`--tools-steps`): finite, 0 frozen, bench
     (b)'s launches for the depth; (d) ablate_step_cost_torch's nine variants,
     4 steps: finite; (e) ablate_keyframes_torch on the stop-and-go city,
     24 frames from frame 64 (`--keyframes-frames`), into its first stop
     (frame 70): three policies with a finite ATE, no-ba with no keyframe
     push, adaptive with at most one push while the camera stands and
     every3 with more; (f) the three debug steppers over frames 3-9 (sift
     and harris for the non-finite stepper): every report present, no
     non-finite pose;
  8. `multiseq`: the lockstep multi-sequence evaluation at full width (the
     entry points of run_multiseq_torch.py --full): six distinct cities,
     640x480, capacity 512, bootstrapped alone, stacked and rolled in
     lockstep in chunks of 64 (captured), then the distorted-lens lane on
     its own; gates the batched launch counts, finiteness, per-lane pose_ok,
     every lane bit-equal to the same lanes rolled eagerly and, at the full
     600 frames a lane (the default; `--multiseq-frames` cuts it), the ATE;
     the seven bootstraps (six lanes, the distorted lens) held card against
     CPU as the headline's; then R inside the graph: three lanes at
     capacity 512, the third fed seeded noise from frame 3 (lost on every frame), 20 steps captured
     against eager bit for bit, the device's count of R's frames equal to
     the eager step's, no sync reported; the eager run's eighs and SVDs
     (R's in float64, the DLT's in float32, the first 4 calls of each
     shape) bit-equal to torch.linalg, each of R's float64 routes met;
  9. `data`: the disk data layer at full width. (a) what the machine has
     for decoding (g++, the png.h and jpeglib.h headers, PIL, cv2,
     matplotlib); the native frame loader must build where the headers
     are, and decode the phase's PNGs bit-equal to png.py (png.py against
     PIL where it cannot build). (b) `generate` writes the first 60 frames
     of the default city; `run_vo_torch.py --dataset parking` over them and
     `--dataset synthetic` give the same poses bit for bit, and K.txt gives
     spec.K(). (c) the city under varying lighting (all 600 frames;
     `--data-frames` cuts it), written by `generate` and run from disk
     (`--chunk 16`, the decode-ahead ring where the native loader built): K1
     steps + 1 and K2 4 x that launches, finite, 0 frozen, pose_ok on all
     but 7 frames, and at 600 frames ATE below max(3 x the headline's ATE,
     0.35 m). (d) `run_multiseq_torch.py` over (c)'s layout at capacity 512,
     40 steps: `--sweep 1`, then six dataset lanes (`--sequences a,...,f`,
     seeds 2023 + i; the sweep's B = 6 would run them again on the one
     clip); K1b once and K2b four times a batched step (B = 1 launches K1
     and K2), finite lanes, each lane's ATE <= 2 m. (e) the JAX package's
     last three public helpers in the port, which hold no kernel
     (ops/image.py `to_grayscale`, `gaussian_kernel1d`, ops/triangulate.py
     `depths_in_frame`), on the card against their CPU results on seeded
     inputs: a 480x640 RGB frame in both channel orders (atol 1e-4), the
     taps at four sigmas (rtol 1e-6), 1,024 points under 3 poses (rtol
     1e-6, atol 1e-5);
 10. `harris`, `sift`, `loop`: the entry point `run_vo_torch.py` through its
     own `run` function, at full width (640x480, capacity 1024). `harris`:
     `--tracker harris` over the 600-frame city with a checkpoint after
     every chunk (the corner kernel's (harris, 7, 5) instance twice at
     bootstrap and once a step, no gather launch; ATE <= 40 m, pose_ok >=
     60%); its bootstrap held card against CPU as the headline's; the
     frames on which the recovery R ran, as the device counted
     them, equal to the frames that lost their pose, and at least one at
     full length; the checkpoint written before R's first chunk resumed
     eagerly (`--no-graph`) for two chunks or more, until R has run 4
     times (at most 8 chunks), poses and table bit-equal to the captured
     run; R's inputs and drawn uniforms on its first 4 frames kept from
     that eager run and R (float64 on both devices) run again on the card
     and on the CPU: on each frame the same inlier count and the same
     take, poses within 1e-3 degree and 1e-3 m, both finite, the card's
     rerun the step's own R bit for bit; then its first 40 frames again,
     bit-equal. `sift`: `--tracker
     sift` over the first 150 frames (no kernel launch at all). `loop`:
     `--spec loop --pose-graph --chunk 16` over the 1,169-frame closed
     circuit (KLT + BA + the Sim(3) pose-graph back-end), gating the launch
     counts, the graph's size, the verified loops and the ATE before and
     after the correction; then the checkpoint written mid-run is resumed
     for 16 frames through a fresh runner (the graphs captured anew) and
     held bit for bit against the straight run.
     Each prints one JSON line.
 11. `dist`: the distributed layer (vo_tpu_torch.parallel). (a) In a real
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

Every rollout of every phase replays the step's CUDA graph unless it is
an eager warm-up or the eager comparison named above; a capture or a replay
that fails raises and fails its phase (nothing falls back to eager, and no
predicate is read on the host). The kernels' launch counts are the graphs'
replays': a capture records what a graph launches and each replay adds
it.

Prints the card line, a JSON line describing every kernel (its times beside
its bound, the plain version and, where there is one, a single PyTorch
call), and as the last line {"ok": true, "device": {...}}. Any failed phase
exits non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REFERENCE_ATE_M = 1.181  # tools/headline_expected.json (the JAX package)
ATE_GATE_M = 1.77  # 1.5x the reference, just above its 1.753 m regression
POSE_OK_SLACK = 7  # pose_ok must hold on all but this many frames
TRACED_FRAMES = 8  # frames of captured replays traced by torch.profiler
# The default city's length: the harris, multiseq and data (c) phases run it
# whole by default, and their ATE gates apply only there.
CITY_FRAMES = 600

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
RECOVERY_STEPS = 20  # steps of the three lanes whose third loses its pose (>= 16)
DLT_HELD_FRAMES = 16  # the headline's first eager steps whose DLT eigh meets torch.linalg's
ROUTE_CALLS = 4  # calls of each cuSOLVER routine and shape held to torch.linalg in R's run

# The run_vo_torch phases. ATE yardsticks are the JAX package's own figures
# (EVAL.md, taken on a TPU): yardsticks of ACCURACY only.
HARRIS_REFERENCE_ATE_M = 4.237  # --tracker harris, 600 frames, one draw
# The harris tracker's ATE and pose_ok share follow the RANSAC draw, not the
# port: seeds 2023 and 1-4 (tools/tracker_seeds_torch.py) on an NVIDIA H100
# 80GB HBM3 at 700 W, with the recovery on its own stream, gave 7.01-36.20 m
# and 430-597 of 597 frames, the recovery on 0-167 of them; the JAX package
# itself, in float32 on a CPU over the same frames
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
HARRIS_CHUNK = 16  # frames a chunk of the harris run; a checkpoint after each
# R's first frames whose inputs from the card are run again on the CPU, and
# the most chunks the eager resume from before R's first chunk runs to reach
# them (at least two).
R_HELD_FRAMES = 4
R_EAGER_MAX_CHUNKS = 8
# R runs in float64 on both devices (models/pipeline.py::recover_pose), so on
# each held frame the card and the CPU must count the same inliers, take the
# same decision and give poses this close (in float32 the two parted by up to
# 0.29 degree and 0.42 m on the city's second turn). The bootstrap's solve is
# float64 too (pipeline.two_view_f64) and held to the same limits, its
# translation in units of its baseline (in float32: 0.0016 degree, 0.00038
# and one landmark apart on the headline's).
R_CARD_CPU_DEG = 1e-3
R_CARD_CPU_M = 1e-3
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
# The data phase: the default city written to disk and read back. (b) cuts
# it to 60 frames; (c) writes all of it under varying lighting (its ATE gate
# applies only there; --data-frames cuts it); (d) runs the dataset lanes
# over (c)'s layout; (e) holds the helpers that hold no kernel on the card
# to their CPU results (seeded inputs).
DATA_EQUAL_FRAMES = 60
DATA_CHUNK = 16
DATA_DECODE_CHECK = 8  # frames decoded by two decoders, bit for bit
# tests/test_lighting.py's gate: varying lighting within 3x the ATE of the
# same city under constant lighting, and never below 0.35 m.
LIGHTING_ATE_FACTOR, LIGHTING_ATE_FLOOR_M = 3.0, 0.35
DATA_LANES, DATA_LANE_CAPACITY, DATA_LANE_STEPS = 6, 512, 40
DATA_LANE_ATE_M = 2.0  # the multiseq floor
HELPERS_SEED = 11
HELPERS_SIGMAS, HELPERS_RADII = (0.5, 1.0, 1.6, 3.0), (None, 2)
HELPERS_POSES, HELPERS_POINTS = 3, 1024
HELPERS_GRAY_ATOL = 1e-4  # on the 0-255 scale: the dot's sums run in another order
HELPERS_RTOL, HELPERS_DEPTH_ATOL = 1e-6, 1e-5
# The bench phase: KITTI 05's frame size and focal length (the JAX harness's
# flagship step, __graft_entry__.py) and the probe's 6 frames; the
# solver pairs' agreement (tests/test_torch_tools.py's tolerance).
KITTI_H, KITTI_W, KITTI_FOCAL = 370, 1226, 707.0912
BENCH_PROBE_FRAMES = 6
SOLVER_REL_TOL = 1e-4
# The tools phase: the remaining tool twins at cut depths over the
# headline's city (--repro-frames, --tools-steps, --keyframes-frames run
# them deeper); the debug steppers step frames 3-9 and report from frame 6.
TOOLS_REPRO_FRAMES = 24
TOOLS_STEPS = 4  # probe_ablate and ablate_step_cost, a warm-up and one timed rollout
# The keyframe ablation rolls the stop-and-go city from frame 64 into its
# first stop (frames 70-115), where the adaptive policy stops pushing.
TOOLS_KEYFRAMES_FIRST, TOOLS_KEYFRAMES_FRAMES = 64, 24
TOOLS_DEBUG_FIRST, TOOLS_DEBUG_LAST = 6, 10
# The repro's `klt_pallas_off` runs K2's and LK's plain versions. Before the
# LK solve kernel the default ran K2's kernel (bit-equal to its plain
# version) and the plain solve, so `klt_pallas_off` must give that default's
# poses bit for bit: their `poses_sha256` over the first TOOLS_REPRO_FRAMES
# frames of the headline's city, taken from the default of the commit before
# the kernel on an NVIDIA H100 80GB HBM3 (700 W), in two processes.
REPRO_PLAIN_POSES_SHA256 = "b33282b8fbb24bc3"
# Inputs one phase leaves for a later one (the headline's BA window and ATE,
# the loop's pose graph).
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


def _with_lk(want: dict) -> dict:
    """Launch counts wanted of a run, with the LK solve's: one launch beside
    each gather pair (one a pyramid level), batched where the pair is."""
    return {**want, "lk_solve": want["extract_patches"],
            "lk_solve_batched": want["extract_patches_batched"]}


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


def _lk_bound(record: dict, lanes: int, k: int) -> None:
    """The LK solve of a level reads both patch sets once and each point's
    sub-pixel offset, search origin and guess, and writes its flow,
    condition, error and live iterations once (counted as the pair's bound
    counts the patches it writes)."""
    n = lanes * k
    patches = n * (LK_TSIZE * LK_TSIZE + LK_SSIZE * LK_SSIZE) * 4
    _bound(record, patches + n * (2 * 2 * 4 + 2 * 4) + n * (2 * 4 + 1 + 4 + 4), 0)


def _lk_levels_kept(dev, lanes: int, k: int) -> list:
    """The arguments of each level's `lk_solve` in one `pyramidal_lk_counted`
    call over the headline's city at 640x480, frames i and i + 2 in lane i,
    K points a lane: its strongest corners for half of them, the rest
    anywhere in the frame (many not conditioned, as on the path). Coarsest
    level first, as (the level's (h, w), its arguments)."""
    import torch
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.ops import image as timg
    from vo_tpu_torch.ops import kernels, klt

    frames = synthetic.render_sequence(synthetic.DEFAULT_SPEC, dev, lanes + 2).frames
    h, w = frames.shape[-2:]
    rng = np.random.default_rng(19)
    pts = []
    for b in range(lanes):
        resp = kernels.corner_response_nms(frames[b], "shi_tomasi", 7, 0.08, 8)
        top = torch.topk(torch.nan_to_num(resp, neginf=-1.0).flatten(), k // 2).indices
        rest = rng.uniform(0, [w - 1, h - 1], (k - k // 2, 2)).astype(np.float32)
        pts.append(torch.cat([torch.stack([top % w, top // w], -1).float(),
                              torch.as_tensor(rest, device=dev)]))
    xy, prev, nxt = torch.stack(pts), frames[:lanes], frames[2:lanes + 2]
    if lanes == 1:
        xy, prev, nxt = xy[0], prev[0], nxt[0]
    kept, real = [], klt.lk_solve

    def keeping(*args, **kwargs):
        kept.append(args[:9])  # the level's inputs, without its count list
        return real(*args, **kwargs)

    p0 = timg.build_pyramid(prev, len(LK_LEVEL_SHAPES))
    klt.lk_solve = keeping
    try:
        klt.pyramidal_lk_counted(p0, timg.build_pyramid(nxt, len(LK_LEVEL_SHAPES)), xy)
    finally:
        klt.lk_solve = real
    return list(zip([tuple(p.shape[-2:]) for p in reversed(p0)], kept))


def _lk_parity(dev, tag: str, record: dict, lanes: int, k: int) -> None:
    """The LK solve kernel against `lk_solve_plain` on each level's own
    patches: G's condition on 99.9% of the points or more and the live
    iterations within 0.5%; of the points both call conditioned with an
    error under 25, those both stopped by the eps test after the same
    iterations within 1e-3 px and 1e-4 of the error (relative, 1e-4 absolute
    at the floor), and 99% of all of them within 1e-3 px (one still moving
    after max_iters has no answer up to rounding, one whose last update sits
    on the eps test may stop an iteration apart); each level timed beside
    its bound."""
    import torch
    from vo_tpu_torch.ops import kernels, klt

    levels, fails = [], []
    for hw, args in _lk_levels_kept(dev, lanes, k):
        got_live, want_live = [], []
        flow, cond, err = kernels.lk_solve(*args, got_live, use_kernel=True)
        pflow, pcond, perr = klt.lk_solve_plain(*args, want_live)
        torch.cuda.synchronize()
        live, plive = got_live[0].long(), want_live[0].long()
        both = cond & pcond & (err < 25.0) & (perr < 25.0)
        settled = both & (live == plive) & (live < args[6])
        gap = (flow - pflow).abs().amax(-1)
        egap = (err - perr).abs()[settled]
        row = dict(level=list(hw), points=lanes * k, tracked=int(both.sum()),
                   settled=int(settled.sum()),
                   cond_equal_share=float((cond == pcond).float().mean()),
                   flow_gap_px_settled=float(gap[settled].max()),
                   flow_gap_px_max=float(gap[both].max()),
                   flow_within_share=float((gap[both] <= 1e-3).float().mean()),
                   err_gap_rel_settled=float((egap / perr[settled].abs().clamp(min=1.0)).max()),
                   live_kernel=int(live.sum()), live_plain=int(plive.sum()))
        if not (row["cond_equal_share"] >= 0.999 and row["flow_gap_px_settled"] <= 1e-3
                and bool((egap <= 1e-4 * perr[settled].abs() + 1e-4).all())
                and row["flow_within_share"] >= 0.99
                and abs(row["live_kernel"] - row["live_plain"]) <= 0.005 * row["live_plain"]):
            fails.append(f"level {row['level']}: {row}")

        def kernel(a=args):
            return kernels.lk_solve(*a, use_kernel=True)

        row["ms"], row["plain_ms"] = _interleaved(lambda a=args: klt.lk_solve_plain(*a), kernel)
        row["device_ms"] = _device_ms(kernel)
        _lk_bound(row, lanes, k)
        print(f"[{tag}] {lanes} x {k} points on {hw}: {json.dumps(row)}")
        levels.append(row)
    finest = levels[-1]
    record.update({key: finest[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                "bound_by")},
                  max_abs_err=max(r["flow_gap_px_settled"] for r in levels), library_ms=None,
                  levels=levels, step_device_ms=sum(r["device_ms"] for r in levels),
                  step_bound_ms=sum(r["bound_ms"] for r in levels))
    print(f"[{tag}] the four levels: {record['step_device_ms']:.4f} ms on the device, bound "
          f"{record['step_bound_ms']:.5f} ms")
    if fails:
        raise AssertionError("; ".join(fails))


def phase_lk(dev, record: dict) -> None:
    _lk_parity(dev, "lk", record, 1, 1024)


def phase_lkb(dev, record: dict) -> None:
    _lk_parity(dev, "lkb", record, MULTISEQ_LANES, 1024)


def phase_headline(dev, n_frames: int, records: dict, city_root: str) -> None:
    """bench_torch.py's headline (bench.py's synthetic half) through its own
    `bench_synthetic_full`: the city written under `city_root` and read back
    through the loader, a warm-up and a timed rollout from one bootstrap."""
    import torch

    import bench_torch
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models import graphed
    from vo_tpu_torch.models.pipeline import vo_rollout
    from vo_tpu_torch.ops import cusolver, kernels
    from vo_tpu_torch.utils.cache import runner_key
    from vo_tpu_torch.utils.config import VOConfig

    levels = VOConfig().klt.pyramid_levels
    spec = dataclasses.replace(synthetic.DEFAULT_SPEC, num_frames=n_frames)
    t0 = time.perf_counter()
    synthetic.generate(str(Path(city_root) / "synthetic"), spec, verbose=False, device=dev)
    print(f"[headline] wrote {n_frames} frames of the city in {time.perf_counter() - t0:.1f} s")

    graphed.RUNNERS.clear()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _dlt_held_to_torch_linalg(DLT_HELD_FRAMES) as dlt, _bootstrap_inputs_kept() as boot:
        run = bench_torch.bench_synthetic_full(dev, city_root)
    t_all = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    warm, outs = run.rollouts.warm, run.rollouts.timed
    steps = outs.pose.shape[0]
    cfg = VOConfig(capacity=bench_torch.SYNTHETIC_CAPACITY)
    frame = torch.from_numpy(run.seq.get_frame(0))
    runner = graphed.RUNNERS.find(runner_key(cfg, 1, *frame.shape, frame.dtype, dev))
    # The replays as the card ran them: TRACED_FRAMES more frames (the last
    # ones, backwards) through the same runner under torch.profiler; the
    # trace's K1 and K2 kernels against the launches the runner counted.
    back = torch.as_tensor(np.stack([run.seq.get_frame(len(run.seq) - 1 - i)
                                     for i in range(TRACED_FRAMES)]), device=dev)
    captures = graphed.RUNNERS.captures
    traced = _traced_kernels(lambda: vo_rollout(
        run.rollouts.state, back, torch.as_tensor(run.seq.K, device=dev), cfg))
    print(f"[headline] {TRACED_FRAMES} traced replays: kernels in the trace "
          f"{traced['trace']}, launches counted {traced['counted']}")

    poses = bench_torch.step_poses(run.boot_pose, outs)
    pose_ok = int(outs.pose_ok.sum())
    frozen = int(outs.frozen.sum())
    finite = int(np.isfinite(poses[2:]).all(axis=(1, 2)).sum())
    # The eager warm-up against the captured timed rollout: every field.
    equal = {name: bool(torch.equal(a, b)) for name, a, b in zip(outs._fields, warm, outs)}
    same = all(equal.values())
    res = run.result
    ate = res["ate_rmse_m"]
    print(f"[headline] bench_synthetic_full: {t_all:.1f} s (decode, bootstrap, warm-up and "
          f"timed rollouts); the eager warm-up {res['warm_fps']:.2f} frames/s, the capture "
          f"{res['capture_s']:.2f} s, the timed {steps} steps ({run.rollouts.executor}) in "
          f"{run.rollouts.seconds:.2f} s = {res['value']:.2f} frames/s")
    graphs = None
    if runner is not None:
        st = runner.stats
        graphs = dict(graphs=st.graphs, conditional_nodes=st.conditionals,
                      capture_s=round(st.capture_s, 3),
                      syncs_per_step=st.syncs / max(st.frames, 1),
                      recoveries=st.recoveries, keyframes=st.keyframes, frames=st.frames)
        print(f"[headline] one graph a frame: {st.graphs['frame']} nodes, "
              f"{st.conditionals} IF nodes (R's body {st.graphs.get('R')} nodes, C's "
              f"{st.graphs.get('C')}); captured in {st.capture_s:.2f} s; syncs a step "
              f"torch's detector reported {graphs['syncs_per_step']:.2f}; on the device's "
              f"count R ran on "
              f"{st.recoveries} of {st.frames} frames, C on {st.keyframes}")
    routes = dict(library=cusolver._lib()._name, frames=len(dlt),
                  shape=dlt[0]["shape"] if dlt else None,
                  finite=[c["finite"] for c in dlt], equal=all(c["equal"] for c in dlt),
                  max_abs=max((c["max_abs"] for c in dlt if c["finite"]), default=None))
    print(f"[headline] the DLT's eigh on the card against torch.linalg.eigh over the eager "
          f"warm-up's first {routes['frames']} frames ({routes['shape']}, finite systems "
          f"{routes['finite']}): bit-equal {routes['equal']} (max |diff| {routes['max_abs']}; "
          f"{routes['library']})")
    # The bootstrap's two-view solve, again on the card and the CPU from its
    # kept inputs and uniforms: gated below with the rest.
    fails = []
    boot_held = _bootstraps_held("headline", boot, ["headline"], fails)
    print(f"[headline] ATE {ate:.4f} m (reference {REFERENCE_ATE_M} m, drift "
          f"{100.0 * (ate - REFERENCE_ATE_M) / REFERENCE_ATE_M:+.1f}%), "
          f"RPE {res['rpe_trans_m']:.5f} m / {res['rpe_rot_deg']:.5f} deg")
    print(f"[headline] pose_ok {pose_ok}/{steps}, finite {finite}/{steps}, frozen {frozen}; "
          f"the captured rollout's StepOutputs bit-equal to the eager warm-up's: {same}")
    print(f"[headline] launches (bootstrap + both rollouts): {json.dumps(counts)}")
    print(json.dumps(dict(phase="headline", **res, executor=run.rollouts.executor,
                          seconds=run.rollouts.seconds,
                          warm_seconds=run.rollouts.warm_seconds,
                          warm_equals_timed=same, fields_equal=equal, graphs=graphs,
                          launches=counts, traced=traced, linalg_routes=routes,
                          bootstrap_card_vs_cpu=boot_held)))
    records["corner_response_nms"]["launches"] = counts["corner_response_nms"]
    records["extract_patches"]["launches"] = counts["extract_patches"]
    records["lk_solve"]["launches"] = counts["lk_solve"]
    HANDOFF["ba_window"] = (run.rollouts.state.window, torch.as_tensor(run.seq.K, device=dev))
    HANDOFF["headline_ate"] = ate
    HANDOFF["headline_result"] = res

    # The frames as the loader read them against the reference numpy renderer.
    rects, tex = synthetic.scene(spec)
    gt = synthetic.make_path(spec.path, n_frames)
    for i in (0, n_frames // 2):
        ref = synthetic.render_frame(rects, tex, gt[i], spec.K(), spec.width, spec.height,
                                     dist=spec.dist)
        d = np.abs(run.seq.get_frame(i) - ref.astype(np.float32)).max()
        print(f"[headline] frame {i}: device render from disk vs numpy max diff {d:.0f} "
              "grey levels")
        if d > 2:
            raise AssertionError(f"renderer disagrees with the reference at frame {i}: {d}")

    # Both rollouts launch: 1 corner kernel at bootstrap and one a step, one
    # gather pair a pyramid level at bootstrap and a step.
    want_k1 = 1 + 2 * steps
    if counts["corner_response_nms"] != want_k1:
        fails.append(f"K1 launched {counts['corner_response_nms']} times, want {want_k1}")
    if counts["extract_patches"] != levels * want_k1:
        fails.append(f"K2 launched {counts['extract_patches']} times, want {levels * want_k1}")
    if counts["lk_solve"] != levels * want_k1:
        fails.append(f"the LK solve launched {counts['lk_solve']} times, want "
                     f"{levels * want_k1}")
    if not same:
        d = float((warm.pose - outs.pose).abs().max())
        fails.append(f"the captured rollout differs from the eager warm-up in "
                     f"{[k for k, v in equal.items() if not v]} (poses max {d:.3g})")
    if run.rollouts.executor != "graphs" or runner is None:
        fails.append(f"the timed rollout ran {run.rollouts.executor}, not the captured graphs")
    elif set(graphs["graphs"]) != {"frame", "R", "C"} or graphs["conditional_nodes"] != 2 \
            or graphs["syncs_per_step"] != 0:
        fails.append(f"want one graph a frame holding two IF nodes (R, C) and no host sync, "
                     f"got {graphs}")
    if (routes["frames"] != DLT_HELD_FRAMES or not routes["equal"]
            or min(routes["finite"], default=0) == 0):
        fails.append(f"the DLT's eigh route against torch.linalg.eigh over the warm-up's "
                     f"first {DLT_HELD_FRAMES} frames: {routes}")
    want_traced = {"corner_nms_kernel": TRACED_FRAMES,
                   "patch_gather_kernel": levels * TRACED_FRAMES,
                   "lk_solve_kernel": levels * TRACED_FRAMES}
    if (traced["trace"] != want_traced or traced["counted"] != want_traced
            or traced["executor"] != "graphs" or graphed.RUNNERS.captures != captures):
        fails.append(f"{TRACED_FRAMES} traced frames ran {traced['executor']} "
                     f"({graphed.RUNNERS.captures - captures} new captures) with kernels "
                     f"{traced['trace']} in the trace and {traced['counted']} counted, "
                     f"want {want_traced} of the cached runner's graphs")
    if finite != steps or frozen:
        fails.append(f"{steps - finite} non-finite poses, {frozen} frozen frames")
    if pose_ok < steps - POSE_OK_SLACK:
        fails.append(f"pose_ok on {pose_ok}/{steps} frames, want >= {steps - POSE_OK_SLACK}")
    if not ate <= ATE_GATE_M:
        fails.append(f"ATE {ate:.4f} m above the {ATE_GATE_M} m gate")
    if fails:
        raise AssertionError("; ".join(fails))


def _capturing(A) -> bool:
    """Whether A's work is going into a CUDA graph now (no read allowed)."""
    import torch

    return A.is_cuda and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def _dlt_held_to_torch_linalg(frames: int):
    """While open, the step's DLT eigh (pipeline.step_eigh's `eigh_finite`:
    cuSOLVER on the card) is also run through torch.linalg.eigh on the same
    systems for its first `frames` calls outside a capture (in the
    headline: the eager warm-up's first frames, from the bootstrap state
    with the run's own draws), and the two are compared bit for bit on the
    finite systems (a non-finite one is the identity on both routes and its
    result is thrown away). Yields the records, one a call."""
    import torch

    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.ops import linalg

    real = pipeline.eigh_finite
    calls = []

    def held(A):
        out = real(A)
        if len(calls) < frames and not _capturing(A):
            ok, systems = linalg._finite_rows(A)
            want = torch.linalg.eigh(systems)
            pairs = [(o[ok], w[ok]) for o, w in zip(out, want)]
            calls.append(dict(shape=list(A.shape), finite=int(ok.sum()),
                              equal=all(torch.equal(o, w) for o, w in pairs),
                              max_abs=max(_max_diff(o, w) for o, w in pairs)
                              if bool(ok.any()) else None))
        return out

    pipeline.eigh_finite = held
    try:
        yield calls
    finally:
        pipeline.eigh_finite = real


@contextlib.contextmanager
def _routes_held_to_torch_linalg(per_shape: int):
    """While open, the first `per_shape` calls of each of ops/cusolver.py's
    routines, each dtype and each shape made outside a capture are also run
    through torch.linalg (eigh, svd) on the same input and compared bit for
    bit. Yields {"routine dtype shape": record}."""
    import torch

    from vo_tpu_torch.ops import cusolver

    real = {name: getattr(cusolver, name) for name in ("syev_batched", "gesvdj_batched")}
    plain = {"syev_batched": torch.linalg.eigh, "gesvdj_batched": torch.linalg.svd}
    routes = {}

    def held(name):
        def call(A):
            out = real[name](A)
            r = routes.setdefault(f"{name} {str(A.dtype)[6:]} {list(A.shape)}",
                                  dict(calls=0, equal=True, max_abs=0.0))
            if r["calls"] < per_shape and not _capturing(A):
                want = plain[name](A)
                r["calls"] += 1
                r["equal"] &= all(map(torch.equal, out, want))
                r["max_abs"] = max(r["max_abs"], _max_diff(tuple(out), tuple(want)))
            return out
        return call

    try:
        for name in real:
            setattr(cusolver, name, held(name))
        yield routes
    finally:
        for name, fn in real.items():
            setattr(cusolver, name, fn)


def _traced_kernels(fn) -> dict:
    """One call of fn (rollouts) under torch.profiler, device activity only:
    the kernels of ops/kernels.py in the trace ("trace") and the launches
    their wrappers counted ("counted"), both by the kernel's symbol, and
    what the rollouts ran ("executor")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vo_tpu_torch.models.pipeline import ROLLED, executor_since
    from vo_tpu_torch.ops import kernels

    symbols = sorted(set(kernels.SYMBOLS.values()))
    rolled = dict(ROLLED)
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(
        trace={s: sum(e.count for e in events if s in e.key) for s in symbols},
        counted={s: sum(n for c, n in kernels.launch_counts.items()
                        if kernels.SYMBOLS[c] == s) for s in symbols},
        executor=executor_since(rolled))


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
    full = n_frames == CITY_FRAMES
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
    r_before = _recoveries()
    with _bootstrap_inputs_kept(b) as kept:
        boot, outs, dt = runner.run_lockstep(seqs, cfg, adaptive=synthetic.ADAPTIVE_LANES)
    counts = dict(kernels.launch_counts)
    recoveries = _recoveries() - r_before
    poses = outs.pose.cpu().numpy()  # (N, B, 4, 4)
    steps = poses.shape[0]
    pose_ok = outs.pose_ok.sum(dim=0).tolist()
    frozen = outs.frozen.sum(dim=0).tolist()
    print(f"[multiseq] {steps} lockstep steps of {b} lanes in {dt:.2f} s = "
          f"{1e3 * dt / steps:.1f} ms a step, {b * steps / dt:.2f} frames/s aggregate, "
          f"{steps / dt:.2f} frames/s a lane")
    print(f"[multiseq] launches (bootstraps + rollout): {json.dumps(counts)}; R ran on "
          f"{recoveries} frames of the lanes by the device's count")
    want = _with_lk({
        "corner_response_nms": b, "extract_patches": levels * b,
        "corner_response_nms_batched": steps,
        "extract_patches_batched": levels * steps,
    })
    if counts != want:
        fails.append(f"launches {counts}, want {want}")
    records["corner_response_nms_batched"]["launches"] = counts["corner_response_nms_batched"]
    records["extract_patches_batched"]["launches"] = counts["extract_patches_batched"]
    records["lk_solve_batched"]["launches"] = counts["lk_solve_batched"]

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

    # The same lanes rolled eagerly: the captured rollout equals it, every
    # StepOutput field of every lane, bit for bit.
    _, eager, edt = runner.run_lockstep(seqs, cfg, adaptive=synthetic.ADAPTIVE_LANES,
                                        graph=False)
    equal = [all(torch.equal(a[:, i], e[:, i]) for a, e in zip(outs, eager))
             for i in range(b)]
    print(f"[multiseq] eager lockstep: {b * steps / edt:.2f} frames/s aggregate against "
          f"{b * steps / dt:.2f} captured; lanes bit-equal to the eager rollout: {equal}")
    print(json.dumps(dict(phase="multiseq", lanes=names, steps=steps,
                          agg_fps_graphs=b * steps / dt, agg_fps_eager=b * steps / edt,
                          lanes_equal_eager=equal, launches=counts,
                          recoveries=recoveries)))
    if not all(equal):
        fails.append(f"captured lanes differ from the eager rollout: {equal}")
    del seqs, outs, eager
    torch.cuda.empty_cache()

    # The distorted-lens lane on its own (distortion is static in the config).
    dseq = synthetic.render_sequence(synthetic.distorted_spec(n_frames), dev)
    dcfg = dataclasses.replace(cfg, dist=synthetic.DISTORTED_DIST)
    kernels.reset_launch_counts()
    r_before = _recoveries()
    with _bootstrap_inputs_kept() as dkept:
        dboot, douts, ddt = runner.run_single(dseq, dcfg, seed=2030)
    dcounts = dict(kernels.launch_counts)
    dsteps = douts.pose.shape[0]
    print(f"[multiseq] distorted lane: {dsteps} steps in {ddt:.2f} s = "
          f"{dsteps / ddt:.2f} frames/s; launches {json.dumps(dcounts)}; R ran on "
          f"{_recoveries() - r_before} frames by the device's count")
    dwant = _with_lk({
        "corner_response_nms": dsteps + 1, "extract_patches": levels * (dsteps + 1),
        "corner_response_nms_batched": 0, "extract_patches_batched": 0,
    })
    if dcounts != dwant:
        fails.append(f"distorted lane launches {dcounts}, want {dwant}")
    dgt = dseq.gt_poses[[0, 2] + list(range(3, 3 + dsteps))]
    judge("distorted", runner.lane_poses(dboot, douts.pose.cpu().numpy()), dgt,
          int(douts.pose_ok.sum()), int(douts.frozen.sum()), dsteps)
    records["corner_response_nms"]["launches_multiseq"] = (
        counts["corner_response_nms"] + dcounts["corner_response_nms"])
    records["extract_patches"]["launches_multiseq"] = (
        counts["extract_patches"] + dcounts["extract_patches"])
    # The seven bootstraps (the six lanes', the distorted lens') again on the
    # card and the CPU.
    held = _bootstraps_held("multiseq", kept + dkept, names + ["distorted"], fails)
    print(json.dumps(dict(phase="multiseq", part="bootstrap_card_vs_cpu", held=held)))
    del dseq, douts, kept, dkept
    _free()
    _recovery_in_the_graph(dev, cfg, fails)
    if fails:
        raise AssertionError("; ".join(fails))


def _recovery_in_the_graph(dev, cfg, fails: list) -> None:
    """Three lanes at 640x480, capacity 512: two of the city with their own
    seeds and one fed seeded noise from frame 3, which loses its pose on
    every frame, so the captured rollout takes R inside its IF node on
    every frame. Captured against eager, every StepOutput field bit for
    bit, and the device's count of R's frames against the eager step's;
    the eager run's eighs and SVDs (R's in float64) against torch.linalg,
    bit for bit."""
    import torch

    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models import graphed, pipeline
    from vo_tpu_torch.parallel import multiseq

    steps = RECOVERY_STEPS
    seq = synthetic.render_sequence(synthetic.DEFAULT_SPEC, dev, steps + 3)
    frames = seq.frames
    lost = frames.clone()
    lost[3:] = torch.as_tensor(np.random.default_rng(99).uniform(
        0, 255, tuple(lost[3:].shape)).astype(np.float32), device=dev)
    states = [pipeline.bootstrap(f[0], f[2], seq.K, cfg,
                                 torch.Generator(device=dev).manual_seed(s))[0]
              for f, s in ((frames, 2023), (frames, 2024), (lost, 2025))]
    state = multiseq.stack_states(states)
    images = torch.stack([frames[3:], frames[3:], lost[3:]], dim=1)
    Ks = seq.K.expand(3, 3, 3).contiguous()
    rewind = pipeline.rewinder(state)
    taken = []
    eager_branch = pipeline.eager_branch

    def counting(name, pred, run, skipped):
        taken.append((name, bool(pred)))
        return eager_branch(name, pred, run, skipped)

    pipeline.eager_branch = counting
    try:
        with _routes_held_to_torch_linalg(ROUTE_CALLS) as routes:
            t0 = time.perf_counter()
            _, eager = multiseq.batched_vo_rollout(state, images, Ks, cfg, graph=False)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
    finally:
        pipeline.eager_branch = eager_branch
    rewind()
    graphed.RUNNERS.clear()
    t0 = time.perf_counter()
    _, got = multiseq.batched_vo_rollout(state, images, Ks, cfg)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    st = graphed.RUNNERS.runners()[0].stats
    equal = {name: bool(torch.equal(a, b)) for name, a, b in zip(got._fields, eager, got)}
    eager_r = sum(ran for name, ran in taken if name == "R")
    eager_c = sum(ran for name, ran in taken if name == "C")
    print(f"[multiseq] R in the graph: 3 lanes (one fed noise), {steps} steps; eager "
          f"{eager_s:.2f} s (with the route checks), captured {graph_s:.2f} s with the "
          f"capture; pose_ok by lane {got.pose_ok.sum(dim=0).tolist()}; R ran on "
          f"{st.recoveries} frames by the device's count ({eager_r} eager), C on "
          f"{st.keyframes} ({eager_c}); syncs torch's detector reported {st.syncs}; "
          f"captured equal to eager {equal}")
    for key, r in routes.items():
        print(f"[multiseq] the eager run's {key} on the card against torch.linalg, "
              f"{r['calls']} calls: bit-equal {r['equal']} (max |diff| {r['max_abs']:.3g})")
    print(json.dumps(dict(phase="multiseq", part="recovery_in_graph", steps=steps,
                          fields_equal=equal, recoveries=st.recoveries,
                          eager_recoveries=eager_r, keyframes=st.keyframes,
                          eager_keyframes=eager_c, syncs=st.syncs, graphs=st.graphs,
                          conditional_nodes=st.conditionals, linalg_routes=routes)))
    if not all(equal.values()):
        fails.append(f"R in the graph: captured differs from eager in "
                     f"{[k for k, v in equal.items() if not v]}")
    # R's eighs and SVDs run in float64 (the DLT's in float32): each route
    # of each dtype met, and every one bit-equal to torch.linalg.
    unequal = [key for key, r in routes.items() if not r["equal"]]
    met = {" ".join(key.split()[:2]) for key in routes}
    want_met = {"syev_batched float64", "gesvdj_batched float64", "syev_batched float32"}
    if unequal or not want_met <= met:
        fails.append(f"R in the graph: cuSOLVER routes not bit-equal to torch.linalg "
                     f"{unequal}; routes met {sorted(met)}, want {sorted(want_met)}")
    if (st.recoveries, st.keyframes) != (eager_r, eager_c) or st.recoveries < steps:
        fails.append(f"R in the graph: the device counted R {st.recoveries} and C "
                     f"{st.keyframes} times, eager {eager_r} and {eager_c}; want R on all "
                     f"{steps} frames")
    if st.syncs:
        fails.append(f"R in the graph: {st.syncs} host syncs")
    graphed.RUNNERS.clear()


def _kitti_sized_kernels(dev, records: dict) -> None:
    """(a) K1 and the K2 pair at KITTI 05's frame size, 370x1226, and at its
    pyramid levels (all but the first odd-sided), against their plain
    versions as `_k1_parity` and `_pair_case` hold them; timed."""
    import torch

    import bench_torch
    from vo_tpu_torch.ops.image import build_pyramid
    from vo_tpu_torch.utils.config import VOConfig

    cfg = VOConfig(capacity=bench_torch.KITTI_CAPACITY)
    shape = (KITTI_H, KITTI_W)
    k1 = {}
    _k1_parity(dev, k1, "bench", [(shape, m) for m in K1_MODES], shape)
    levels = [tuple(x.shape) for x in build_pyramid(torch.zeros(shape), cfg.klt.pyramid_levels)]
    rng = np.random.default_rng(13)
    timed = [_pair_case(dev, rng, "bench", lvl, cfg.capacity, lvl == shape) for lvl in levels]
    pair = {}
    _pair_record(pair, timed[0], shape, cfg.capacity)
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    records["corner_response_nms"]["at_370x1226"] = {k: k1[k] for k in keys}
    records["extract_patches"]["at_370x1226"] = dict(
        {k: pair[k] for k in keys}, levels=[list(x) for x in levels], k=cfg.capacity)
    print(json.dumps(dict(phase="bench", part="kernels_370x1226", levels=levels,
                          k1={k: k1[k] for k in keys}, pair={k: pair[k] for k in keys})))


def _kitti_sized_probe(dev, records: dict, fails: list) -> None:
    """(b) bench_torch.bench_kitti_probe over the first frames of the city
    rendered at KITTI's size and focal length (no KITTI images are in the
    repository): 40 ping-ponged steps, warm-up and timed."""
    import torch

    import bench_torch
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.utils.config import VOConfig

    spec = dataclasses.replace(synthetic.DEFAULT_SPEC, width=KITTI_W, height=KITTI_H,
                               focal=KITTI_FOCAL)
    seq = synthetic.render_sequence(spec, dev, BENCH_PROBE_FRAMES)
    kernels.reset_launch_counts()
    r_before = _recoveries()
    fps, runs = bench_torch.bench_kitti_probe(list(seq.frames), seq.K, dev,
                                              bench_torch.KITTI_STEPS)
    counts = dict(kernels.launch_counts)
    recoveries = _recoveries() - r_before
    steps = runs.timed.pose.shape[0]
    finite = int(torch.isfinite(runs.timed.pose).all(dim=(1, 2)).sum())
    frozen = int(runs.timed.frozen.sum()) + int(runs.warm.frozen.sum())
    same = bool(torch.equal(runs.warm.pose, runs.timed.pose))
    line = dict(phase="bench", part="kitti_sized_probe", frame=[KITTI_H, KITTI_W],
                focal=KITTI_FOCAL, frames=BENCH_PROBE_FRAMES, steps=steps,
                capacity=bench_torch.KITTI_CAPACITY, kitti05_sized_fps=fps,
                executor=runs.executor, warm_fps=steps / runs.warm_seconds,
                capture_s=runs.capture_seconds,
                seconds=runs.seconds, pose_ok=int(runs.timed.pose_ok.sum()), finite=finite,
                frozen=frozen, warm_equals_timed=same, launches=counts,
                recoveries=recoveries)
    print(json.dumps(line))
    levels = VOConfig().klt.pyramid_levels
    want = _with_lk({"corner_response_nms": 1 + 2 * steps,
                     "extract_patches": levels * (1 + 2 * steps),
                     "corner_response_nms_batched": 0, "extract_patches_batched": 0})
    if counts != want:
        fails.append(f"(b) launches {counts}, want {want}")
    if finite != steps or frozen or not bool(torch.isfinite(runs.warm.pose).all()):
        fails.append(f"(b) {steps - finite} non-finite timed poses, {frozen} frozen frames")
    if not same:
        fails.append("(b) the timed rollout's poses differ from the warm-up's")
    if runs.executor != "graphs":
        fails.append(f"(b) the timed rollout ran {runs.executor}, not the captured graphs")
    records["corner_response_nms"]["launches_bench"] = counts["corner_response_nms"]
    records["extract_patches"]["launches_bench"] = counts["extract_patches"]


def phase_bench(dev, records: dict, city_root: str) -> None:
    """The measurement entry points on the card: (a) the kernels at KITTI's
    frame size, (b) bench_torch's KITTI-sized probe, (c) tools/roofline_torch.py
    and tools/profile_all_torch.py over the 640x480 city the headline wrote,
    (d) tools/bench_solvers_torch.py and tools/bench_pg_torch.py."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import bench_pg_torch
    import bench_solvers_torch
    import profile_all_torch
    import roofline_torch

    fails = []
    card = _card_line()
    _kitti_sized_kernels(dev, records)
    _kitti_sized_probe(dev, records, fails)
    _free()

    # (c) The roofline, then the profile part by part, host against device.
    rows = roofline_torch.roofline(dev)
    roofline_torch.print_table(rows, card)
    print(json.dumps(dict(phase="bench", part="roofline", device=card, rows=rows)))
    if not all(r["ms"] is not None and np.isfinite(r["ms"]) for r in rows):
        fails.append("(c) a roofline row without a finite time")
    frames, K = profile_all_torch.read_frames("synthetic", city_root, dev)
    rows = profile_all_torch.profile(frames, K, dev)
    print(f"[bench] profile on {card}")
    profile_all_torch.print_table(rows)
    print(json.dumps(dict(phase="bench", part="profile", device=card,
                          frame=list(frames.shape[-2:]), rows=rows)))
    if not all(r["device_ms"] is not None and np.isfinite([r["host_ms"], r["device_ms"]]).all()
               for r in rows):
        fails.append("(c) a profile row without finite host and device times")
    del frames
    _free()

    # (d) The solver pairs and the pose graph.
    solvers = bench_solvers_torch.bench(dev)
    print(json.dumps(dict(phase="bench", part="solvers", device=card, **solvers)))
    for key in ("ba_pose_rel_diff", "ba_landmark_rel_diff", "pnp_solve_rel_diff"):
        if not solvers[key] < SOLVER_REL_TOL:
            fails.append(f"(d) {key} {solvers[key]:.3g}, want < {SOLVER_REL_TOL}")
    pg = bench_pg_torch.bench(dev)
    print(json.dumps(dict(phase="bench", part="pose_graph", device=card, **pg)))
    if not (np.isfinite(pg["err_last"]) and pg["err_last"] < pg["err0"] and pg["dist_equal"]):
        fails.append(f"(d) pose graph: err {pg['err0']} -> {pg['err_last']}, one rank "
                     f"equal {pg['dist_equal']}")
    if fails:
        raise AssertionError("; ".join(fails))


def _tools_rows(tag: str, rows: list, fails: list, steps: int) -> dict:
    """Rows by variant; a failed variant, a non-finite pose or a frozen
    frame fails the phase."""
    for r in rows:
        if "error" in r:
            fails.append(f"{tag} {r['variant']}: {r['error']}")
        elif r["finite"] != steps or r.get("frozen", 0):
            fails.append(f"{tag} {r['variant']}: {steps - r['finite']} non-finite poses, "
                         f"{r.get('frozen', 0)} frozen")
    return {r["variant"]: r for r in rows}


def phase_tools(dev, records: dict, city_root: str, repro_frames: int, steps: int,
                keyframes_frames: int) -> None:
    """The remaining tool twins on the card, over the headline's city: (a)
    tools/check_headline_torch.py's gate on the headline phase's own result,
    (b) repro_headline_torch (the kernels on and off), (c) probe_ablate_torch,
    (d) ablate_step_cost_torch, (e) ablate_keyframes_torch on the stop-and-go
    city, (f) the three debug steppers."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import ablate_keyframes_torch
    import bench_torch
    import ablate_step_cost_torch
    import check_headline_torch
    import debug_candidate_gates_torch
    import debug_sift_nan_torch
    import debug_track_drift_torch
    import probe_ablate_torch
    import repro_headline_torch
    from vo_tpu_torch.ops import kernels

    fails = []
    card = _card_line()
    t0 = time.perf_counter()

    def done(part: str) -> None:
        print(f"[tools] {part} in {time.perf_counter() - t0:.1f} s from the phase's start",
              flush=True)

    kernels.reset_launch_counts()

    # (a) The drift gate, on the headline's own run (no second run); a
    # rehearsal with fewer frames reports and does not gate.
    res = HANDOFF.get("headline_result")
    exp = json.loads(check_headline_torch.EXPECTED_PATH.read_text())
    if res is None:
        fails.append("(a) the headline phase left no result")
    else:
        ok, drift = check_headline_torch.gate(res, exp, exp["tol_pct"])
        gated = res["frames"] == exp["frames"]
        print(json.dumps(dict(phase="tools", tool="check_headline_torch", device=card,
                              ate_rmse_m=res["ate_rmse_m"], expected_ate_m=exp["ate_rmse_m"],
                              expected_device=exp.get("device"), drift_pct=drift,
                              tol_pct=exp["tol_pct"], ok=ok, gated=gated)))
        if gated and not ok:
            fails.append(f"(a) headline ATE {res['ate_rmse_m']} m drifts {drift:.2f}% from "
                         f"{exp['ate_rmse_m']} m (tol {exp['tol_pct']}%)")

    # (b) The kernels on and off: each toggle's launches; with the klt
    # kernels off, the plain route's poses as before the LK solve kernel.
    imgs, K, seq = bench_torch.read_city(city_root, dev, repro_frames)
    n = imgs.shape[0] - 3
    rows = _tools_rows("(b)", repro_headline_torch.repro(imgs, K, seq.gt_poses, dev,
                                                         also_detect=True), fails, n)
    del imgs
    print(json.dumps(dict(phase="tools", tool="repro_headline_torch", device=card,
                          frames=n + 3, rows=list(rows.values()))))
    on = n + 1  # the bootstrap's launch and one a step
    want = {"pallas_auto(default)": (on, 4 * on, 4 * on), "klt_pallas_off": (on, 0, 0),
            "detect_pallas_off": (0, 4 * on, 4 * on), "all_pallas_off": (0, 0, 0)}
    for name, (k1, k2, lk) in want.items():
        r = rows.get(name, {})
        if "error" not in r and (r.get("k1"), r.get("k2"), r.get("lk")) != (k1, k2, lk):
            fails.append(f"(b) {name}: launches K1 {r.get('k1')} / K2 {r.get('k2')} / LK "
                         f"solve {r.get('lk')}, want {k1} / {k2} / {lk}")
    plain = rows.get("klt_pallas_off", {}).get("poses_sha256")
    if repro_frames == TOOLS_REPRO_FRAMES and plain != REPRO_PLAIN_POSES_SHA256:
        fails.append(f"(b) klt_pallas_off's poses hash to {plain}, want "
                     f"{REPRO_PLAIN_POSES_SHA256}: the plain LK route moved")
    _free()
    done("(b)")

    # (c) The probe ablation at KITTI's frame size, one timed repeat.
    frames, K, source = probe_ablate_torch.probe_frames(city_root, dev)
    rows = _tools_rows("(c)", probe_ablate_torch.probe(frames, K, dev, steps, repeats=1),
                       fails, steps)
    del frames
    print(json.dumps(dict(phase="tools", tool="probe_ablate_torch", device=card,
                          frames=source, steps=steps, repeats=1, rows=list(rows.values()))))
    k1 = 1 + 2 * steps  # bench (b)'s count for the depth
    for name, r in rows.items():
        if "error" not in r and (r["k1"], r["k2"]) != (k1, 4 * k1):
            fails.append(f"(c) {name}: launches K1 {r['k1']} / K2 {r['k2']}, want "
                         f"{k1} / {4 * k1}")
    _free()
    done("(c)")

    # (d) The step-cost ablation, one timed repeat.
    imgs, K, _ = bench_torch.read_city(city_root, dev, 3 + steps)
    rows = _tools_rows("(d)", ablate_step_cost_torch.ablate(imgs, K, dev, steps, repeats=1),
                       fails, steps)
    del imgs
    print(json.dumps(dict(phase="tools", tool="ablate_step_cost_torch", device=card,
                          steps=steps, repeats=1, rows=list(rows.values()))))
    _free()
    done("(d)")

    # (e) The keyframe policies on the stop-and-go city, into its first stop:
    # adaptive pushes at most once after the camera stops (the baseline it
    # gathered before), every3 goes on pushing.
    first = TOOLS_KEYFRAMES_FIRST
    rows = _tools_rows("(e)", ablate_keyframes_torch.stopgo(
        str(Path(city_root) / "stopgo"), first + keyframes_frames, dev,
        ablate_keyframes_torch.trials(), first), fails, keyframes_frames - 3)
    print(json.dumps(dict(phase="tools", tool="ablate_keyframes_torch", device=card,
                          scenario="stopgo", first=first, frames=keyframes_frames,
                          rows=list(rows.values()))))
    if len(rows) != 3 or not all(np.isfinite(r.get("ate_m", np.nan)) for r in rows.values()):
        fails.append("(e) want three policies with a finite ATE")
    stood = {k: r.get("pushes_stopped") for k, r in rows.items()}
    if rows.get("no-ba", {}).get("pushes") != 0:
        fails.append(f"(e) no-ba pushed {rows.get('no-ba', {}).get('pushes')} keyframes")
    elif not rows.get("every3", {}).get("stopped_steps"):
        fails.append("(e) the rollout never reached the stop")
    elif not (stood.get("adaptive", 99) <= 1 and stood.get("every3", 0) > stood["adaptive"]):
        fails.append(f"(e) keyframes pushed while the camera stood: {stood}; want adaptive "
                     "at most 1 and every3 more")
    _free()
    done("(e)")

    # (f) The debug steppers over a few frames each.
    first, last = TOOLS_DEBUG_FIRST, TOOLS_DEBUG_LAST
    drift = debug_track_drift_torch.run(city_root, dev, first, last)
    gates = debug_candidate_gates_torch.run(city_root, dev, first, last)
    nan = {t: debug_sift_nan_torch.run(city_root, dev, t, last) for t in ("sift", "harris")}
    print(json.dumps(dict(phase="tools", tool="debug_steppers", device=card, first=first,
                          last=last, track_drift=drift, candidate_gates=gates,
                          sift_nan={t: dict(rc=rc, rows=r) for t, (rc, r) in nan.items()})))
    if len(drift) != last - first or not all(
            np.isfinite([r["med_r_start"], r["med_r_now"]]).all() for r in drift):
        fails.append(f"(f) track drift: {len(drift)} finite reports, want {last - first}")
    if len(gates) != last - first or not all(
            r["good"] <= r["pass_bear"] <= r["cand"] for r in gates):
        fails.append("(f) candidate gates: a report missing or counts out of order")
    for t, (rc, r) in nan.items():
        if rc != 0 or len(r) != last - 3:
            fails.append(f"(f) {t}: exit {rc} over {len(r)} frames, want 0 over {last - 3}")

    done("(f)")
    counts = dict(kernels.launch_counts)
    print(f"[tools] launches over the phase: {json.dumps(counts)}")
    records["corner_response_nms"]["launches_tools"] = counts["corner_response_nms"]
    records["extract_patches"]["launches_tools"] = counts["extract_patches"]
    if fails:
        raise AssertionError("; ".join(fails))


def _probe_toolchain() -> dict:
    """What this machine has for the native frame loader and the figures:
    a C++ compiler, the libpng and libjpeg headers (preprocessed, so every
    include path counts), PIL, cv2 and matplotlib."""
    import importlib.util
    import shutil

    cxx = shutil.which("g++") or shutil.which("c++")
    found = {"cxx": cxx}
    for header in ("png.h", "jpeglib.h"):
        ok = False
        if cxx:
            src = f"#include <cstdio>\n#include <{header}>\n"
            ok = subprocess.run([cxx, "-E", "-x", "c++", "-o", "/dev/null", "-"], input=src,
                                capture_output=True, text=True, timeout=60).returncode == 0
        found[header] = ok
    for package in ("PIL", "cv2", "matplotlib"):
        found[package] = importlib.util.find_spec(package) is not None
    return found


def _data_decoders(paths: list, fails: list) -> dict:
    """(a) The native loader against png.py on the phase's own PNGs, bit for
    bit; where the native loader cannot be built (no headers), png.py
    against PIL."""
    from vo_tpu_torch.data import native_loader, png

    found = _probe_toolchain()
    t0 = time.perf_counter()
    native = native_loader.available()
    line = dict(phase="data", part="decoders", **found, native=native,
                native_build_s=round(time.perf_counter() - t0, 3),
                native_error=native_loader.build_error())
    if found["cxx"] and found["png.h"] and found["jpeglib.h"] and not native:
        fails.append(f"the native loader did not build: {native_loader.build_error()}")
    if native:
        other, name = native_loader.decode_gray, "native"
    elif found["PIL"]:
        from PIL import Image

        other, name = (lambda p: np.asarray(Image.open(p).convert("L"), np.float32)), "PIL"
    else:
        other, name = None, None
    line["checked"] = f"png.py vs {name}" if name else "png.py alone"
    t0 = time.perf_counter()
    frames = [png.read_gray(p) for p in paths]
    line["png_py_ms_a_frame"] = round(1e3 * (time.perf_counter() - t0) / len(paths), 3)
    if other is not None:
        t0 = time.perf_counter()
        again = [other(p) for p in paths]
        line[f"{name}_ms_a_frame"] = round(1e3 * (time.perf_counter() - t0) / len(paths), 3)
        line["bit_equal"] = all(np.array_equal(a, b) for a, b in zip(frames, again))
        if not line["bit_equal"]:
            fails.append(f"png.py and {name} decode differently")
    line["frames_checked"] = len(paths)
    print(json.dumps(line))
    return line


def phase_data(dev, n_frames: int, records: dict) -> None:
    """The disk data layer at full width: `generate` writes the default city
    to disk, `run_vo_torch.py --dataset parking` and `run_multiseq_torch.py`
    read it back through vo_tpu_torch.data.Sequence."""
    import shutil
    import tempfile
    from glob import glob

    import torch

    import run_multiseq_torch as runner
    from vo_tpu_torch.data import Sequence, synthetic
    from vo_tpu_torch.ops import kernels

    fails = []
    tmp = Path(tempfile.mkdtemp(prefix="vo_data_"))
    try:
        # (b) disk equals device: 60 frames through both entry paths.
        spec = synthetic.DEFAULT_SPEC
        t0 = time.perf_counter()
        synthetic.generate(str(tmp / "equal" / "parking"),
                           dataclasses.replace(spec, num_frames=DATA_EQUAL_FRAMES),
                           verbose=False, device=dev)
        t_gen60 = time.perf_counter() - t0
        paths = sorted(glob(str(tmp / "equal" / "parking" / "images" / "*.png")))
        _data_decoders(paths[:DATA_DECODE_CHECK], fails)
        common = ["--max-frames", str(DATA_EQUAL_FRAMES), "--chunk", str(DATA_CHUNK), "--quiet"]
        disk = _drive(["--dataset", "parking", "--data-root", str(tmp / "equal"), *common])
        device = _drive(common)
        seq = Sequence("parking", path=str(tmp / "equal"))
        k_equal = bool(np.array_equal(seq.K, spec.K().astype(np.float32)))
        equal = bool(np.array_equal(disk.poses, device.poses))
        print(json.dumps(dict(phase="data", part="disk_equals_device", frames=DATA_EQUAL_FRAMES,
                              generate_s=round(t_gen60, 2), poses_bit_equal=equal,
                              K_equal=k_equal, decoder=disk.result["decoder"],
                              prefetch=disk.result["prefetch"],
                              ate_disk_m=disk.result.get("ate_rmse_m"),
                              ate_device_m=device.result.get("ate_rmse_m"))))
        if not equal:
            d = np.abs(disk.poses - device.poses).max()
            fails.append(f"(b) disk and device poses differ (max {d:.3g})")
        if not k_equal:
            fails.append(f"(b) K.txt gives {seq.K.tolist()}, spec.K() {spec.K().tolist()}")
        del disk, device
        _free()

        # (c) the whole city under varying lighting, from disk.
        lit = dataclasses.replace(spec, lighting="varying", num_frames=n_frames)
        root = tmp / "lit"
        t0 = time.perf_counter()
        synthetic.generate(str(root / "parking"), lit, verbose=False, device=dev)
        t_gen = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(p) for p in glob(str(root / "parking" / "images" / "*")))
        kernels.reset_launch_counts()
        done = _drive(["--dataset", "parking", "--data-root", str(root),
                       "--chunk", str(DATA_CHUNK), "--quiet"])
        counts = dict(kernels.launch_counts)
        line = dict(phase="data", part="varying_lighting_from_disk",
                    **_run_gates("data (c)", done, fails, 0.0),
                    **done.result, launches=counts, generate_s=round(t_gen, 2),
                    png_bytes=on_disk, raw_bytes=n_frames * lit.width * lit.height)
        steps = line["steps"]
        want = _with_lk({"corner_response_nms": steps + 1, "extract_patches": 4 * (steps + 1),
                         "corner_response_nms_batched": 0, "extract_patches_batched": 0})
        if counts != want:
            fails.append(f"(c) launches {counts}, want {want}")
        if line["pose_ok"] < steps - POSE_OK_SLACK:
            fails.append(f"(c) pose_ok on {line['pose_ok']}/{steps} frames, want >= "
                         f"{steps - POSE_OK_SLACK}")
        headline = HANDOFF.get("headline_ate", ATE_GATE_M)
        gate = max(LIGHTING_ATE_FACTOR * headline, LIGHTING_ATE_FLOOR_M)
        line.update(ate_gate_m=gate, headline_ate_m=headline)
        if n_frames == CITY_FRAMES and not done.result.get("ate_rmse_m", np.inf) < gate:
            fails.append(f"(c) ATE {done.result.get('ate_rmse_m')} m not below {gate:.3f} m")
        print(json.dumps(line))
        records["corner_response_nms"]["launches_data"] = counts["corner_response_nms"]
        records["extract_patches"]["launches_data"] = counts["extract_patches"]
        del done
        _free()

        # (d) the dataset lanes over (c)'s layout, through
        # run_multiseq_torch.main: the sweep at B = 1, then the dataset mode's
        # six lanes (seeds 2023 + i). The sweep's B = 6 would repeat the
        # latter on the one clip, so the sweep runs B = 1 alone.
        batches = []
        run_batch = runner.run_batch

        def recording(*a, **kw):
            out = run_batch(*a, **kw)
            batches.append(out)
            return out

        base = ["--dataset", "parking", "--data-root", str(root),
                "--capacity", str(DATA_LANE_CAPACITY), "--steps", str(DATA_LANE_STEPS)]
        lanes = ",".join("abcdef"[:DATA_LANES])
        runner.run_batch = recording
        try:
            for argv, b in ((["--sweep", "1"], 1), (["--sequences", lanes], DATA_LANES)):
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                rc = runner.main(base + argv)
                dt = time.perf_counter() - t0
                counts = dict(kernels.launch_counts)
                mode = argv[0].lstrip("-")
                # The batch: its bootstraps (single launches), then a warm-up
                # and a timed rollout; B = 1 launches the single kernels.
                n = 2 * DATA_LANE_STEPS
                single, batched = (n, 0) if b == 1 else (0, n)
                want = _with_lk({"corner_response_nms": b + single,
                                 "extract_patches": 4 * (b + single),
                                 "corner_response_nms_batched": batched,
                                 "extract_patches_batched": 4 * batched})
                print(json.dumps(dict(phase="data", part=f"lanes_{mode}", rc=rc,
                                      seconds=round(dt, 2), launches=counts, want=want)))
                if rc != 0 or counts != want:
                    fails.append(f"(d) {mode}: exit {rc}, launches {counts}, want {want}")
        finally:
            runner.run_batch = run_batch
        fps, ates, _, poses = batches[-1]
        if not (np.isfinite(fps) and np.isfinite(poses).all()):
            fails.append("(d) non-finite lanes")
        if not all(a is not None and a <= DATA_LANE_ATE_M for a in ates):
            fails.append(f"(d) lane ATEs {ates}, want each <= {DATA_LANE_ATE_M} m")
        records["corner_response_nms_batched"]["launches_data"] = counts[
            "corner_response_nms_batched"]
        records["extract_patches_batched"]["launches_data"] = counts["extract_patches_batched"]
        del batches
        _free()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(dict(phase="data", part="helpers", **_helpers_held(dev, fails))))
    if fails:
        raise AssertionError("; ".join(fails))


def _helpers_held(dev, fails: list) -> dict:
    """(e) The JAX package's last three public helpers in the port, none of
    which holds a kernel (ops/image.py `to_grayscale`, `gaussian_kernel1d`;
    ops/triangulate.py `depths_in_frame`): on `dev` against their CPU
    results on seeded inputs. Returns the largest errors."""
    import torch

    from vo_tpu_torch.ops.image import gaussian_kernel1d, to_grayscale
    from vo_tpu_torch.ops.triangulate import depths_in_frame

    cpu = torch.device("cpu")
    rng = np.random.default_rng(HELPERS_SEED)
    frame = torch.from_numpy(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
    gray = {order: _max_diff(to_grayscale(frame.to(dev), order).cpu(),
                             to_grayscale(frame, order))
            for order in ("rgb", "bgr")}
    if not all(d <= HELPERS_GRAY_ATOL for d in gray.values()):
        fails.append(f"(e) to_grayscale differs from the CPU's by {gray}")
    taps = {}
    for sigma in HELPERS_SIGMAS:
        for radius in HELPERS_RADII:
            got = gaussian_kernel1d(sigma, radius, device=dev).cpu()
            want = gaussian_kernel1d(sigma, radius, device=cpu)
            taps[f"{sigma}/{radius}"] = float(((got - want).abs() / want.abs()).max())
            if got.shape != want.shape or not torch.allclose(got, want, rtol=HELPERS_RTOL,
                                                             atol=0.0):
                fails.append(f"(e) gaussian_kernel1d({sigma}, {radius}) differs from the "
                             f"CPU's: {got.tolist()} against {want.tolist()}")
    # Random rotations (QR, det +1), translations within 10 m, points within 50 m.
    q, r = np.linalg.qr(rng.normal(size=(HELPERS_POSES, 3, 3)))
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    T = np.tile(np.eye(4), (HELPERS_POSES, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = q, rng.uniform(-10, 10, (HELPERS_POSES, 3))
    T_cw = torch.from_numpy(T.astype(np.float32))[:, None]  # (3, 1, 4, 4): a pose a row
    X = torch.from_numpy(rng.uniform(-50, 50, (HELPERS_POSES, HELPERS_POINTS, 3))
                         .astype(np.float32))
    want = depths_in_frame(T_cw, X)
    got = depths_in_frame(T_cw.to(dev), X.to(dev)).cpu()
    depth = _max_diff(got, want)
    if got.shape != want.shape or not torch.allclose(got, want, rtol=HELPERS_RTOL,
                                                     atol=HELPERS_DEPTH_ATOL):
        fails.append(f"(e) depths_in_frame differs from the CPU's by {depth}")
    return dict(gray_max_abs=gray, taps_max_rel=taps, depths_max_abs=depth,
                depths_shape=list(got.shape))


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


def _recoveries() -> int:
    """The frames on which R ran in every cached runner so far, as the
    device counted them (a device read)."""
    from vo_tpu_torch.models import graphed

    return (graphed.summary() or {}).get("recoveries", 0)


def _free() -> None:
    """Hand the device memory of the runs just dropped back to the card,
    the captured runners' graphs and static buffers included."""
    import torch

    from vo_tpu_torch.models import graphed

    graphed.RUNNERS.clear()
    torch.cuda.empty_cache()


def phase_harris(dev, n_frames: int, records: dict) -> None:
    """`run_vo_torch.py --tracker harris`: Harris detection through the
    corner kernel's (harris, 7, 5) instance, matched-patch tracking. The
    tracker starves at the city's second turn, so the recovery R runs on
    real frames inside the frame's graph: its frames are counted on the
    device, the chunks from the one where R first ran are run again eagerly
    from the checkpoint before them, and R's first frames again on the CPU."""
    from vo_tpu_torch.models import graphed
    from vo_tpu_torch.ops import kernels

    fails = []
    base = ["--tracker", "harris", "--chunk", str(HARRIS_CHUNK), "--quiet"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, before_r = str(Path(tmp) / "harris.npz"), str(Path(tmp) / "before_r.npz")
        seen = {}

        def observer(frame, state, backend):
            # Until R first runs, keep the checkpoint of the chunk's end
            # (the one before R's first chunk, once it does); from there,
            # the table where the eager resume is to stop.
            taken = graphed.summary()["recoveries"]  # a device read, between chunks
            if "r_chunk" not in seen:
                if taken:
                    seen.update(r_chunk=frame, chunks=1)
                else:
                    for suffix in ("", ".json"):
                        shutil.copyfile(ckpt + suffix, before_r + suffix)
                    seen["ckpt_frame"] = frame
            elif "upto" not in seen:
                seen["chunks"] += 1
                if taken >= R_HELD_FRAMES or seen["chunks"] == R_EAGER_MAX_CHUNKS:
                    seen.update(upto=frame, table=[f.clone() for f in state.table])

        kernels.reset_launch_counts()
        with _bootstrap_inputs_kept() as kept:
            done = _drive(base + ["--max-frames", str(n_frames), "--checkpoint", ckpt,
                                  "--checkpoint-every", str(HARRIS_CHUNK)], observer)
        counts = dict(kernels.launch_counts)
        line = dict(phase="harris", **_run_gates("harris", done, fails, HARRIS_POSE_OK_SHARE),
                    **done.result, launches=counts,
                    bootstrap_card_vs_cpu=_bootstraps_held("harris", kept, ["harris"], fails))
        steps = line["steps"]
        want = _with_lk({"corner_response_nms": 2 + steps, "extract_patches": 0,
                         "corner_response_nms_batched": 0, "extract_patches_batched": 0})
        if counts != want:
            fails.append(f"launches {counts}, want {want}")
        ate = done.result.get("ate_rmse_m", np.inf)
        line.update(ate_yardstick_m=HARRIS_REFERENCE_ATE_M,
                    ate_within_twice_yardstick=bool(ate <= 2.0 * HARRIS_REFERENCE_ATE_M),
                    ate_limit_m=HARRIS_ATE_LIMIT_M)
        if n_frames == CITY_FRAMES and not ate <= HARRIS_ATE_LIMIT_M:
            fails.append(f"ATE {ate} m above the {HARRIS_ATE_LIMIT_M} m limit")
        records["corner_response_nms"]["launches_harris"] = counts["corner_response_nms"]
        records["extract_patches"]["launches_harris"] = counts["extract_patches"]

        # (a) R's frames as the device counted them. R runs where PnP lost
        # the pose; with no frozen frame those are the frames not pose_ok.
        recoveries = done.result["graphs"]["recoveries"]
        lost = [s["frame"] for s in done.stats if not s["ok"]]
        line.update(recoveries=recoveries, first_lost=lost[:12],
                    eager_equal_on_R_chunks=None, R_card_vs_cpu=[])
        if done.result["executor"] != "graphs":
            fails.append(f"the run ran {done.result['executor']}, not the captured graphs")
        if recoveries != len(lost):
            fails.append(f"R ran on {recoveries} frames by the device's count, but "
                         f"{len(lost)} frames lost their pose")
        if n_frames == CITY_FRAMES and not recoveries:
            fails.append("R ran on no frame of the run: nothing holds it")
        if recoveries and "ckpt_frame" not in seen:
            fails.append(f"R ran in the first chunk (by frame {seen['r_chunk']}): no "
                         "checkpoint before it to resume")
        elif recoveries:
            if "upto" not in seen:  # the run ended first
                seen.update(upto=done.frame_ids[-1], table=list(done.state.table))
            line["eager_equal_on_R_chunks"], line["R_card_vs_cpu"] = _harris_r_held(
                base, before_r, seen, done, fails)
    fails += _r_card_vs_cpu_fails(line["R_card_vs_cpu"])

    # The first frames again: a seeded run reproduces bit for bit.
    n_rep = min(REPEAT_FRAMES, n_frames)
    again = _drive(base + ["--max-frames", str(n_rep)])
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


def _harris_r_held(base: list, ckpt: str, seen: dict, done, fails: list):
    """(b) The checkpoint `ckpt` (written after frame seen["ckpt_frame"],
    before R's first chunk) resumed eagerly up to frame seen["upto"]: poses
    and table bit-equal to the captured run `done`. (c) R's first frames of
    that eager run kept and run again on the CPU. Returns (bit-equal,
    R's records)."""
    import torch

    upto = seen["upto"]
    with _recovery_inputs_kept(R_HELD_FRAMES) as kept:
        back = _drive(base + ["--resume", ckpt, "--max-frames", str(upto + 1), "--no-graph"])
    n_rows = done.frame_ids.index(upto) + 1
    same_ids = back.frame_ids == done.frame_ids[:n_rows]
    same_poses = same_ids and bool(np.array_equal(back.poses, done.poses[:n_rows]))
    same_table = all(torch.equal(a, b) for a, b in zip(back.state.table, seen["table"]))
    equal = bool(same_poses and same_table and back.result["executor"] == "eager")
    if not equal:
        fails.append(f"the eager resume from frame {seen['ckpt_frame']} to {upto} differs "
                     f"from the captured run: poses {same_poses}, table {same_table}, "
                     f"executor {back.result['executor']}")
    # R runs on the eager run's frames that lost their pose, in order.
    lost = [s["frame"] for s in back.stats if not s["ok"]]
    if len(kept) != min(len(lost), R_HELD_FRAMES):
        fails.append(f"R kept {len(kept)} calls over {len(lost)} lost frames")
    held = _r_card_vs_cpu(kept)
    for frame, rec in zip(lost, held):
        rec["frame"] = frame
    print(f"[harris] eager resume from frame {seen['ckpt_frame']} (R's first chunk ends at "
          f"{seen['r_chunk']}) to {upto}: bit-equal {equal}; R on {len(lost)} of its frames")
    del back
    return equal, held


@contextlib.contextmanager
def _recovery_inputs_kept(calls: int):
    """While open, the first `calls` calls of the step's recovery
    (pipeline.recover_pose) outside a capture keep copies of everything R
    reads (its tensors, the configuration, this step's drawn uniforms) and
    what it gave. Yields the records, one a call."""
    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.ops.ransac import Drawn

    real = pipeline.recover_pose
    kept = []

    def keeping(*args):
        *tensors, cfg, samplers = args  # the tensors R reads and K, cfg, samplers
        out = real(*args)
        if len(kept) < calls and not _capturing(tensors[0]):
            if not all(isinstance(s, Drawn) for s in samplers):
                raise TypeError("R's samplers are not drawn uniforms: nothing to replay")
            kept.append(dict(args=[t.clone() for t in tensors], cfg=cfg,
                             uniforms=[s.u.clone() for s in samplers],
                             got=[t.clone() for t in out]))
        return out

    pipeline.recover_pose = keeping
    try:
        yield kept
    finally:
        pipeline.recover_pose = real


def _r_card_vs_cpu(kept: list) -> list:
    """R (pipeline.recover_pose) run again over each record of
    `_recovery_inputs_kept`, with its uniforms replayed, on the device it
    was kept on and on the CPU, lane 0. Per record: the rotation
    angle (degrees) and translation distance (m) between the two sides' R
    poses, beside the step length both pin it to (`last_speed`, m), both
    inlier counts, whether each side took R's pose, whether the pose each
    side carries on is finite, and whether the rerun on the kept device
    gave the step's own results bit for bit."""
    import torch

    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.ops.ransac import Drawn

    out = []
    for rec in kept:
        sides = []
        for dev in (rec["args"][0].device, torch.device("cpu")):
            sides.append(pipeline.recover_pose(
                *(t.to(dev) for t in rec["args"]), rec["cfg"],
                [Drawn(u.to(dev)) for u in rec["uniforms"]]))
        card, cpu = (pipeline.Recovered(*(f[0].cpu().double().numpy() for f in side))
                     for side in sides)
        out.append(dict(
            **_poses_apart(card.pose, cpu.pose),
            speed_m=float(rec["args"][4][0]),
            inliers_card=int(card.num_inliers), inliers_cpu=int(cpu.num_inliers),
            took_card=bool(card.took), took_cpu=bool(cpu.took),
            finite=bool(np.isfinite(card.pose_fb).all() and np.isfinite(cpu.pose_fb).all()),
            card_equals_step=all(torch.equal(a, b) for a, b in zip(sides[0], rec["got"]))))
    return out


def _poses_apart(Pa, Pb) -> dict:
    """The rotation angle (degrees) and the translation distance between two
    (4, 4) poses (numpy f64); None where not finite."""
    # 2 asin(|Ra - Rb|_F / (2 sqrt 2)) is the angle of Ra^T Rb, exact near 0.
    chord = np.linalg.norm(Pa[:3, :3] - Pb[:3, :3]) / (2.0 * np.sqrt(2.0))
    angle = float(np.degrees(2.0 * np.arcsin(min(chord, 1.0))))
    trans = float(np.linalg.norm(Pa[:3, 3] - Pb[:3, 3]))
    return dict(angle_deg=angle if np.isfinite(angle) else None,
                trans_m=trans if np.isfinite(trans) else None)


def _r_card_vs_cpu_fails(held: list) -> list:
    """harris (c)'s gate over `_r_card_vs_cpu`'s records: on every held
    frame the card and the CPU count the same inliers and take the same
    decision, their poses lie within R_CARD_CPU_DEG and R_CARD_CPU_M, both
    are finite, and the card's rerun is the step's own R bit for bit."""
    fails = []
    for rec in held:
        where = f"R on frame {rec.get('frame')}"
        if not rec["finite"]:
            fails.append(f"{where}: a non-finite pose on the card or the CPU")
        if rec["inliers_card"] != rec["inliers_cpu"] or rec["took_card"] != rec["took_cpu"]:
            fails.append(f"{where}: inliers {rec['inliers_card']} on the card, "
                         f"{rec['inliers_cpu']} on the CPU; took {rec['took_card']} / "
                         f"{rec['took_cpu']}")
        if not (rec["angle_deg"] is not None and rec["angle_deg"] <= R_CARD_CPU_DEG
                and rec["trans_m"] is not None and rec["trans_m"] <= R_CARD_CPU_M):
            fails.append(f"{where}: card and CPU poses {rec['angle_deg']} degree and "
                         f"{rec['trans_m']} m apart, want <= {R_CARD_CPU_DEG} and "
                         f"{R_CARD_CPU_M}")
        if not rec["card_equals_step"]:
            fails.append(f"{where}: R run again on the card differs from the step's")
    return fails


@contextlib.contextmanager
def _bootstrap_inputs_kept(calls: int = 1):
    """While open, the first `calls` bootstrap solves (pipeline.two_view_f64
    called with a torch.Generator, as `bootstrap` calls it; R calls it with
    lane samplers and is let through) draw their uniforms here, as their
    RANSAC's own `sample_indices` would (one `draw_uniforms` of the same
    shape from the same generator: the same draw and the same indices), and
    keep copies of their inputs, the uniforms and the solve. Yields the
    records, one a bootstrap."""
    import torch

    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.ops.ransac import Drawn, draw_uniforms, drawn_hypotheses

    real = pipeline.two_view_f64
    kept = []

    def keeping(xy0, xy1, valid, K, cfg, stage, samplers, ideal1=False):
        if len(kept) >= calls or not isinstance(samplers, torch.Generator):
            return real(xy0, xy1, valid, K, cfg, stage, samplers, ideal1)
        u = draw_uniforms(samplers, drawn_hypotheses(stage.num_hypotheses), xy0.shape[-2])
        two = real(xy0, xy1, valid, K, cfg, stage, Drawn(u), ideal1)
        kept.append(dict(args=[t.clone() for t in (xy0, xy1, valid, K)], cfg=cfg,
                         stage=stage, ideal1=ideal1, uniforms=u.clone(),
                         got=[t.clone() for part in two for t in part]))
        return two

    pipeline.two_view_f64 = keeping
    try:
        yield kept
    finally:
        pipeline.two_view_f64 = real


def _bootstrap_card_vs_cpu(kept: list, tags: list) -> list:
    """The bootstrap's solve (pipeline.two_view_f64, float64, then
    `bootstrap_map`: the f32 pose of camera 1 and the landmark gates) run
    again over each record of `_bootstrap_inputs_kept` with its uniforms,
    on the device it was kept on and on the CPU, named by `tags`, one a
    record. Per record: the two poses of camera 1 apart (its baseline is
    1), the inlier counts and masks, the landmarks (cheirality-good inliers
    in the depth range) and their masks, whether each pose is finite, and
    whether the rerun on the kept device gave the run's own solve (F,
    inliers, T_21, points) bit for bit."""
    import torch

    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.ops.ransac import Drawn

    out = []
    for i, rec in enumerate(kept):
        sides = []
        for dev in (rec["uniforms"].device, torch.device("cpu")):
            two = pipeline.two_view_f64(*(t.to(dev) for t in rec["args"]), rec["cfg"],
                                        rec["stage"], Drawn(rec["uniforms"].to(dev)),
                                        rec["ideal1"])
            sides.append((two, pipeline.bootstrap_map(two, rec["cfg"])))
        (card, (pose_card, _, good_card)), (cpu, (pose_cpu, _, good_cpu)) = sides
        pose_card, good_card = pose_card.cpu(), good_card.cpu()
        run = [t.cpu() for t in rec["got"]]
        out.append(dict(
            bootstrap=tags[i] if i < len(tags) else f"#{i}",
            **_poses_apart(pose_card.double().numpy(), pose_cpu.double().numpy()),
            pose_bits_equal=bool(torch.equal(pose_card, pose_cpu)),
            inliers_card=int(card.ransac.num_inliers), inliers_cpu=int(cpu.ransac.num_inliers),
            masks_equal=bool(torch.equal(card.ransac.inliers.cpu(), cpu.ransac.inliers)),
            good_card=int(good_card.sum()), good_cpu=int(good_cpu.sum()),
            good_masks_equal=bool(torch.equal(good_card, good_cpu)),
            finite=bool(torch.isfinite(pose_card).all() and torch.isfinite(pose_cpu).all()),
            card_equals_run=all(torch.equal(a.cpu(), b) for a, b in
                                zip((t for part in card for t in part), run))))
    return out


def _bootstraps_held(phase: str, kept: list, tags: list, fails: list) -> list:
    """The bootstraps `kept` in a phase, one for each of `tags`, run again
    on the card and the CPU (`_bootstrap_card_vs_cpu`), printed and gated
    (`_bootstrap_card_vs_cpu_fails`, into `fails`). Returns the records."""
    held = _bootstrap_card_vs_cpu(kept, tags)
    print(f"[{phase}] the bootstrap's two-view solve (float64) again on the card and the "
          f"CPU from its inputs and draws: {json.dumps(held)}")
    if len(kept) != len(tags):
        fails.append(f"kept {len(kept)} bootstraps, want {len(tags)} ({tags})")
    fails += _bootstrap_card_vs_cpu_fails(held)
    return held


def _bootstrap_card_vs_cpu_fails(held: list) -> list:
    """The gate over `_bootstrap_card_vs_cpu`'s records (the headline's,
    multiseq's seven, harris's): on every held bootstrap the card and the
    CPU count the same inliers with the same masks and the same landmarks,
    their poses of camera 1 lie within R_CARD_CPU_DEG and R_CARD_CPU_M of
    the unit baseline, both are finite, and the card's rerun is the run's
    own solve bit for bit."""
    fails = []
    for rec in held:
        where = f"the {rec['bootstrap']} bootstrap"
        if not rec["finite"]:
            fails.append(f"{where}: a non-finite pose on the card or the CPU")
        if rec["inliers_card"] != rec["inliers_cpu"] or not rec["masks_equal"]:
            fails.append(f"{where}: inliers {rec['inliers_card']} on the card, "
                         f"{rec['inliers_cpu']} on the CPU; masks equal {rec['masks_equal']}")
        if rec["good_card"] != rec["good_cpu"]:
            fails.append(f"{where}: {rec['good_card']} landmarks on the card, "
                         f"{rec['good_cpu']} on the CPU")
        if not (rec["angle_deg"] is not None and rec["angle_deg"] <= R_CARD_CPU_DEG
                and rec["trans_m"] is not None and rec["trans_m"] <= R_CARD_CPU_M):
            fails.append(f"{where}: card and CPU poses {rec['angle_deg']} degree and "
                         f"{rec['trans_m']} of the baseline apart, want <= "
                         f"{R_CARD_CPU_DEG} and {R_CARD_CPU_M}")
        if not rec["card_equals_run"]:
            fails.append(f"{where}: the solve run again on the card differs from the run's")
    return fails


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

    from vo_tpu_torch.models import graphed
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
        if res["executor"] != "graphs":
            fails.append(f"the loop ran {res['executor']}, not the captured graphs")
        steps = line["steps"]
        want = _with_lk({"corner_response_nms": 1 + steps,
                         "extract_patches": levels * (1 + steps),
                         "corner_response_nms_batched": 0, "extract_patches_batched": 0})
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
            # A fresh runner: the resume captures its graphs anew.
            graphed.RUNNERS.clear()
            captures = graphed.RUNNERS.captures
            back = _drive(base + ["--resume", ckpt, "--max-frames", str(upto + 1)])
            if graphed.RUNNERS.captures != captures + 1 or back.result["executor"] != "graphs":
                fails.append(f"the resume ran {back.result['executor']} with "
                             f"{graphed.RUNNERS.captures - captures} fresh captures, want "
                             "graphs and 1")
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
    want = _with_lk({"corner_response_nms": [0, 0], "extract_patches": [0, 0],
                     "corner_response_nms_batched": [steps, steps],
                     "extract_patches_batched": [4 * steps, 4 * steps]})
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
    want = _with_lk({"corner_response_nms": steps + 1, "extract_patches": 4 * (steps + 1),
                     "corner_response_nms_batched": 0, "extract_patches_batched": 0})
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


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=600,
                        help="length of the headline sequence (default 600)")
    parser.add_argument("--multiseq-frames", type=int, default=CITY_FRAMES,
                        help=f"frames per lane of the multi-sequence phase (default "
                             f"{CITY_FRAMES}; the ATE gates apply only at that length)")
    parser.add_argument("--harris-frames", type=int, default=CITY_FRAMES,
                        help=f"frames of the harris-tracker run (default {CITY_FRAMES}; "
                             f"the ATE gate and the gate that R ran apply only at that "
                             f"length)")
    parser.add_argument("--sift-frames", type=int, default=150,
                        help="frames of the sift-tracker run (default 150; the ATE "
                             "gate applies at 150 and at 600)")
    parser.add_argument("--data-frames", type=int, default=CITY_FRAMES,
                        help=f"frames of the varying-lighting city the data phase writes "
                             f"and reads (default {CITY_FRAMES}; the ATE gate applies "
                             f"only at that length)")
    parser.add_argument("--loop-frames", type=int, default=LOOP_FRAMES,
                        help=f"frames of the loop-closure run (default {LOOP_FRAMES}; the "
                             "graph and ATE gates apply only at full length)")
    parser.add_argument("--repro-frames", type=int, default=TOOLS_REPRO_FRAMES,
                        help=f"frames of the city the tools phase's kernel on/off runs "
                             f"cover (default {TOOLS_REPRO_FRAMES})")
    parser.add_argument("--tools-steps", type=int, default=TOOLS_STEPS,
                        help=f"steps of the tools phase's probe and step-cost ablations "
                             f"(default {TOOLS_STEPS})")
    parser.add_argument("--keyframes-frames", type=int, default=TOOLS_KEYFRAMES_FRAMES,
                        help=f"frames of the stop-and-go city the tools phase's keyframe "
                             f"ablation rolls, from frame {TOOLS_KEYFRAMES_FIRST} (default "
                             f"{TOOLS_KEYFRAMES_FRAMES})")
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if min(args.frames, args.multiseq_frames, args.harris_frames, args.sift_frames,
           args.loop_frames, args.repro_frames, args.keyframes_frames) < 4 \
            or args.data_frames < 31 or args.tools_steps < 1:
        parser.error("every --*frames must be at least 4, --data-frames at least 31 "
                     "(the lighting curves' smoothing window), --tools-steps at least 1")

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
        # No TPU kernel: the JAX package leaves LK's solve to XLA.
        "lk_solve": dict(name="lk_solve", route="cuda", source="vo_tpu_torch/csrc/lk_solve.cu",
                         replaces=None),
        "lk_solve_batched": dict(name="lk_solve_batched", route="cuda",
                                 source="vo_tpu_torch/csrc/lk_solve.cu", replaces=None),
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
        run("lk", phase_lk, dev, records["lk_solve"])
        run("lkb", phase_lkb, dev, records["lk_solve_batched"])
    city = tempfile.mkdtemp(prefix="vo_city_")  # the headline's city, on disk
    try:
        run("headline", phase_headline, dev, args.frames, records, city)
        run("bench", phase_bench, dev, records, city)
        run("tools", phase_tools, dev, records, city, args.repro_frames, args.tools_steps,
            args.keyframes_frames)
    finally:
        shutil.rmtree(city, ignore_errors=True)
    run("multiseq", phase_multiseq, dev, args.multiseq_frames, records)
    run("data", phase_data, dev, args.data_frames, records)
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
