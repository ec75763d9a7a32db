#!/usr/bin/env python
"""Multi-sequence VO evaluation on one CUDA GPU — the PyTorch/CUDA twin of
`run_multiseq.py --full`.

Renders six DISTINCT synthetic city sequences (varied seeds and paths, one
stop-and-go) on the device, bootstraps each lane on its own, stacks the
states and rolls them full-length in lockstep through ONE batched step
(`vo_tpu_torch.parallel.multiseq.batched_vo_rollout`, chunks of 64 frames);
reports per-lane ATE and aggregate frames/s, plus a distorted-lens lane run
on its own through `vo_rollout` (distortion coefficients are static in the
config).

    python run_multiseq_torch.py --full                      # 6 lanes x 600 frames
    python run_multiseq_torch.py --full --full-lanes city_lr,stopgo --full-frames 120
    python run_multiseq_torch.py --full --device cpu --full-frames 8 --full-lanes 2

Prints one JSON line per lane and a final JSON report (metric, lanes, batch,
steps, agg_fps, device). Only `--full` is ported; the dataset lanes, the
batch-size sweep and the multi-process modes of run_multiseq.py are not yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

CHUNK = 64  # frames per `batched_vo_rollout` call; the state carries across


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--full", action="store_true",
                   help="the full-length multi-sequence accuracy evaluation "
                        "(the only mode ported so far)")
    p.add_argument("--full-frames", type=int, default=600,
                   help="frames per lane")
    p.add_argument("--full-lanes", type=str, default="",
                   help="limit to N lanes (int) or a comma-separated lane-name "
                        "list (e.g. city_lr,stopgo); empty = all six")
    p.add_argument("--capacity", type=int, default=512)
    p.add_argument("--no-kernels", action="store_true",
                   help="route detection/LK through the plain PyTorch chains "
                        "instead of the CUDA kernels (fault isolation)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; fails without a GPU) or cpu, only when asked")
    return p.parse_args(argv)


def lane_poses(first_pose, step_poses) -> np.ndarray:
    """Identity (frame 0), the bootstrap pose, then the step poses."""
    return np.concatenate([
        np.stack([np.eye(4, dtype=np.float32), np.asarray(first_pose, np.float32)]),
        np.asarray(step_poses, np.float32),
    ])


def run_lockstep(seqs: dict, cfg, seed: int = 2023, adaptive=()):
    """Bootstrap every lane of `seqs` (name -> Sequence) alone with its own
    sampler (seed + lane index), stack the states and roll all lanes in
    lockstep over frames 3.. in chunks. Returns (boot_poses (B, 4, 4),
    outs: StepOutput stacked to (N, B, ...), seconds of the rollout)."""
    import torch

    from vo_tpu_torch.models.pipeline import StepOutput, bootstrap
    from vo_tpu_torch.parallel.multiseq import batched_vo_rollout, stack_states

    names = list(seqs)
    first = seqs[names[0]]
    dev = first.frames.device
    states = []
    for i, name in enumerate(names):
        seq = seqs[name]
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        st, _ = bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg, gen)
        states.append(st)
    boot_poses = torch.stack([st.pose for st in states]).cpu().numpy()
    batched = stack_states(states)
    batched = batched._replace(kf_adaptive=torch.tensor(
        [name in adaptive for name in names], device=dev))
    Ks = torch.stack([seqs[name].K for name in names])
    n_steps = min(seqs[name].frames.shape[0] for name in names) - 3
    images = torch.stack([seqs[name].frames[3:3 + n_steps] for name in names], dim=1)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    outs = []
    sync()
    t0 = time.perf_counter()
    for lo in range(0, n_steps, CHUNK):
        batched, out = batched_vo_rollout(batched, images[lo:lo + CHUNK], Ks, cfg)
        outs.append(out)
    sync()
    dt = time.perf_counter() - t0
    return boot_poses, StepOutput(*(torch.cat(f) for f in zip(*outs))), dt


def run_single(seq, cfg, seed: int):
    """One sequence through bootstrap + `vo_rollout` (the distorted lane).
    Returns (boot_pose, outs, seconds)."""
    import torch

    from vo_tpu_torch.models.pipeline import bootstrap, vo_rollout

    dev = seq.frames.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    st, _ = bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg, gen)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    _, outs = vo_rollout(st, seq.frames[3:], seq.K, cfg)
    sync()
    return st.pose.cpu().numpy(), outs, time.perf_counter() - t0


def lane_report(name: str, est: np.ndarray, gt: np.ndarray) -> dict:
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses

    ate = ate_rmse(positions_from_poses(est), positions_from_poses(gt))
    return {"lane": name, "ate_rmse_m": round(float(ate), 3),
            "finite": bool(np.isfinite(est).all())}


def run_full(args) -> int:
    import torch

    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.utils.config import DetectorConfig, KLTConfig, VOConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        print("run_multiseq_torch: no CUDA device visible (pass --device cpu to "
              "run on the CPU)", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    plain = {}
    if args.no_kernels:
        plain = dict(detector=DetectorConfig(use_pallas=False),
                     klt=KLTConfig(use_pallas=False))
    cfg = VOConfig(capacity=args.capacity, **plain)

    seqs = synthetic.multiseq_sequences(dev, args.full_frames, args.full_lanes)
    boot, outs, dt = run_lockstep(seqs, cfg, adaptive=synthetic.ADAPTIVE_LANES)
    poses = outs.pose.cpu().numpy()  # (N, B, 4, 4)
    n_steps = poses.shape[0]
    lanes = []
    for b, (name, seq) in enumerate(seqs.items()):
        gt = seq.gt_poses[[0, 2] + list(range(3, 3 + n_steps))]
        lanes.append(lane_report(name, lane_poses(boot[b], poses[:, b]), gt))
        print(json.dumps(lanes[-1]), flush=True)
    batch = len(seqs)
    del seqs

    # Distorted-lens lane (config-static coefficients -> a run of its own).
    dseq = synthetic.render_sequence(synthetic.distorted_spec(args.full_frames), dev)
    dcfg = dataclasses.replace(cfg, dist=synthetic.DISTORTED_DIST)
    dboot, douts, _ = run_single(dseq, dcfg, seed=2030)
    dgt = dseq.gt_poses[[0, 2] + list(range(3, dseq.frames.shape[0]))]
    lanes.append(lane_report("distorted", lane_poses(dboot, douts.pose.cpu().numpy()), dgt))
    print(json.dumps(lanes[-1]), flush=True)

    print(json.dumps({
        "metric": "multiseq_full",
        "lanes": lanes,
        "batch": batch,
        "steps": int(n_steps),
        "agg_fps": round(batch * n_steps / dt, 2),
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
    }))
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.full:
        print("run_multiseq_torch: only --full is ported (the dataset lanes, "
              "--sweep, --multihost and --seqpar-shards of run_multiseq.py are "
              "listed in ROADMAP.md as still to port)", file=sys.stderr)
        return 2
    return run_full(args)


if __name__ == "__main__":
    sys.exit(main())
