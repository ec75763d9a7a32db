#!/usr/bin/env python
"""Benchmark of vo_tpu_torch: full-sequence VO throughput and accuracy on one
CUDA GPU — the twin of `bench.py`.

Prints ONE JSON line with bench.py's keys: {"metric", "value", "unit",
"vs_baseline", "device", "ate_rmse_m", "rpe_trans_m", "rpe_rot_deg",
"frames", "capacity", "kitti05_sized_fps"}. `device` is the card's name and
power limit as nvidia-smi gives them ("cpu" under `--device cpu`).

Headline: the 600-frame synthetic city (exact GT, two 90-degree turns) read
through `Sequence("synthetic", path=--data-root)` (rendered on the device into
<root>/synthetic the first time), bootstrapped on frames 0 and 2 with a
generator seeded 2023, moved to the device in one transfer, rolled once to
warm up (eagerly) and once timed with `vo_rollout` (one synchronize at the
end), then ATE/RPE against the exact GT. The timed rollout replays the
step's CUDA graph, one a frame (models/graphed.py), captured between the
two rollouts: the line's `executor` says so ("eager" on the CPU), `graphs`
holds the host syncs a step, the recoveries and keyframes counted on the
device and the graphs' nodes, `warm_fps` is the eager warm-up's frames/s
and `capture_s` the capture's seconds.

The two rollouts start from the same state and make the same RANSAC draws:
the state's two samplers (PnP's and the recovery's) are stateful
`torch.Generator`s (in the JAX package the key sits inside the immutable
state), so their states are saved before the warm-up and restored before
the timed run; neither `vo_step` nor the
captured rollout writes the caller's state (the graphs run on static
buffers of their own and hand back copies).

Secondary: the KITTI-05-sized probe (bench.py's `bench_kitti_probe`): the
frames of KITTI 05 under `--kitti-root` (the `kitti/05` layout that
`vo_tpu_torch.data.Sequence` reads), capacity 512, bootstrapped on frames 0
and 2, 40 steps ping-ponged over the sequence, warm-up then timed.
`vs_baseline` is its frames/s over the reference's 15 frames/s, measured on
frames of that size. Where the layout is absent both are null and the line's
`kitti_probe` key names the missing path.

    python bench_torch.py                          # on cuda:0
    python bench_torch.py --kitti-root ./data      # <root>/kitti/05/...
    python bench_torch.py --device cpu             # on the CPU, only when asked
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, NamedTuple

import numpy as np

BASELINE_FPS = 15.0  # the reference on an Apple M2, plotting off (BASELINE.md)
KITTI_STEPS = 40
KITTI_CAPACITY = 512
SYNTHETIC_CAPACITY = 1024
SEED = 2023


class Rollouts(NamedTuple):
    """A warm-up and a timed rollout from one bootstrapped state."""

    warm: Any  # StepOutput of the warm-up, stacked (N, ...)
    timed: Any  # StepOutput of the timed rollout
    state: Any  # the timed rollout's final VOState
    seconds: float  # the timed rollout on the host clock, one sync at its end
    warm_seconds: float  # the eager warm-up, likewise
    capture_seconds: float  # capturing the timed rollout's graphs (0.0: eager)
    executor: str  # what the timed rollout ran: "graphs" or "eager"


class SyntheticRun(NamedTuple):
    result: dict  # bench.py's fields of the headline
    boot_pose: np.ndarray  # (4, 4) the bootstrap's pose of frame 2
    rollouts: Rollouts
    seq: Any  # the data.Sequence read


def sync(dev) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warm_and_timed(state, stack, K, cfg, repeats: int = 1) -> Rollouts:
    """`vo_rollout` over `stack` from `state`: an eager warm-up, the capture
    of the step's CUDA graphs outside the timed window (as the JAX package
    compiles inside its warm-up), then `repeats` timed runs that replay
    them (the CPU runs them eagerly), each with the warm-up's draws (the
    samplers rewound to where they stood before it); `seconds` is the best of
    them, `executor` what the timed runs ran."""
    from vo_tpu_torch.models.graphed import capture_ahead
    from vo_tpu_torch.models.pipeline import ROLLED, executor_since, rewinder, vo_rollout

    dev = stack.device
    rewind = rewinder(state)
    sync(dev)
    t0 = time.perf_counter()
    _, warm = vo_rollout(state, stack, K, cfg, graph=False)
    sync(dev)
    warm_s = time.perf_counter() - t0
    capture_s = capture_ahead(state, stack, K, cfg)
    best = float("inf")
    before = dict(ROLLED)
    for _ in range(repeats):
        rewind()
        sync(dev)
        t0 = time.perf_counter()
        final, timed = vo_rollout(state, stack, K, cfg)
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return Rollouts(warm, timed, final, best, warm_s, capture_s, executor_since(before))


def step_poses(boot_pose, outs) -> np.ndarray:
    """Identity (frame 0), the bootstrap pose (frame 2), then the steps'."""
    return np.concatenate([
        np.stack([np.eye(4, dtype=np.float32), np.asarray(boot_pose, np.float32)]),
        outs.pose.cpu().numpy(),
    ])


def trajectory_errors(boot_pose, outs, gt_poses) -> tuple[float, float, float]:
    """(ATE in m, RPE translation in m, RPE rotation in radians) of
    `step_poses` against the ground truth of frames 0, 2, 3, 4, ..."""
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses, rpe

    est = step_poses(boot_pose, outs)
    gt = gt_poses[[0, 2] + list(range(3, 3 + outs.pose.shape[0]))]
    t_rpe, r_rpe = rpe(est, gt)
    return (float(ate_rmse(positions_from_poses(est), positions_from_poses(gt))),
            float(t_rpe), float(r_rpe))


def read_city(data_root: str, dev, frames: int | None = None):
    """The synthetic city under <data_root>/synthetic (rendered there on
    `dev` the first time): (its first `frames` frames, all by default,
    stacked on the device in one transfer, K on the device, the Sequence)."""
    import torch

    from vo_tpu_torch.data import Sequence

    seq = Sequence("synthetic", path=data_root, render_device=str(dev))
    n = len(seq) if frames is None else min(frames, len(seq))
    imgs = torch.from_numpy(np.stack([seq.get_frame(i) for i in range(n)])).to(dev)
    return imgs, torch.as_tensor(seq.K, device=dev), seq


def bench_synthetic_full(device, data_root: str = "./data",
                         capacity: int = SYNTHETIC_CAPACITY) -> SyntheticRun:
    """The whole synthetic sequence under <data_root>/synthetic: frames/s of
    the timed rollout and ATE/RPE against the exact GT."""
    import torch

    from vo_tpu_torch.models.pipeline import bootstrap
    from vo_tpu_torch.utils.config import VOConfig

    dev = torch.device(device)
    imgs, K, seq = read_city(data_root, dev)
    cfg = VOConfig(capacity=capacity)
    state, out = bootstrap(imgs[0], imgs[2], K, cfg, seeded(dev))
    stack = imgs[3:]  # one transfer; the rollouts read it on the device
    runs = warm_and_timed(state, stack, K, cfg)
    steps = stack.shape[0]

    boot_pose = out.pose.cpu().numpy()
    ate, t_rpe, r_rpe = trajectory_errors(boot_pose, runs.timed, seq.gt_poses)
    result = {
        "value": round(steps / runs.seconds, 3),
        "warm_fps": round(steps / runs.warm_seconds, 3),
        "capture_s": round(runs.capture_seconds, 3),
        "frames": int(steps),
        "ate_rmse_m": round(ate, 4),
        "rpe_trans_m": round(t_rpe, 5),
        "rpe_rot_deg": round(r_rpe * 57.29578, 5),
    }
    return SyntheticRun(result, boot_pose, runs, seq)


def bench_kitti_probe(frames, K, device, steps: int, cfg=None,
                      repeats: int = 1) -> tuple[float, Rollouts]:
    """bench.py's reference-sized probe over `frames` (a list of (H, W) grey
    frames, numpy or tensors) with intrinsics K: `cfg` (default
    VOConfig(capacity=512)), bootstrap on frames 0 and 2, `steps` frames
    ping-ponged through the list (forward from frame 3, back to frame 1,
    then 2 and on), a warm-up and `repeats` timed rollouts. Returns
    (frames/s of the best timed rollout, the rollouts)."""
    import torch

    from vo_tpu_torch.models.pipeline import bootstrap
    from vo_tpu_torch.parallel.multihost import frame_plan
    from vo_tpu_torch.utils.config import VOConfig

    dev = torch.device(device)
    cfg = VOConfig(capacity=KITTI_CAPACITY) if cfg is None else cfg
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    imgs = [torch.as_tensor(f, dtype=torch.float32, device=dev) for f in frames]
    state, _ = bootstrap(imgs[0], imgs[2], K, cfg, seeded(dev))
    stack = torch.stack([imgs[i] for i in frame_plan(len(imgs), steps)])
    runs = warm_and_timed(state, stack, K, cfg, repeats)
    return steps / runs.seconds, runs


def seeded(dev):
    """The RANSAC sampler every entry point bootstraps with."""
    import torch

    return torch.Generator(device=dev).manual_seed(SEED)


def card_name(dev) -> str:
    """The card's name and power limit, as nvidia-smi gives them; "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    from chip_smoke import _card_line

    return _card_line()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", default="./data",
                   help="where the synthetic city is rendered once and read from")
    p.add_argument("--kitti-root", default="./data",
                   help="data root holding kitti/05 (calib.txt, image_0/*.png)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device visible (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    from vo_tpu_torch.data import Sequence
    from vo_tpu_torch.models.graphed import summary as graph_summary

    run = bench_synthetic_full(dev, args.data_root, SYNTHETIC_CAPACITY)
    synth = run.result
    line = {
        "metric": "vo_full_sequence_600_frames",
        "value": synth["value"],
        "unit": "frames/s",
        "vs_baseline": None,
        "executor": run.rollouts.executor,
        "graphs": graph_summary(),
        "warm_fps": synth["warm_fps"],
        "capture_s": synth["capture_s"],
        "device": card_name(dev),
        "ate_rmse_m": synth["ate_rmse_m"],
        "rpe_trans_m": synth["rpe_trans_m"],
        "rpe_rot_deg": synth["rpe_rot_deg"],
        "frames": synth["frames"],
        "capacity": SYNTHETIC_CAPACITY,
        "kitti05_sized_fps": None,
    }
    try:
        kitti = Sequence("kitti", path=args.kitti_root, kitti_sequence="05")
    except FileNotFoundError as exc:
        line["kitti_probe"] = f"absent: {exc.filename or exc}"
    else:
        fps, _ = bench_kitti_probe([kitti.get_frame(i) for i in range(len(kitti))],
                                   kitti.K, dev, KITTI_STEPS)
        line["kitti05_sized_fps"] = round(fps, 3)
        # Like for like: the probe's frames are the size the 15 frames/s was
        # measured on; the 640x480 headline carries no ratio of its own.
        line["vs_baseline"] = round(fps / BASELINE_FPS, 3)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
