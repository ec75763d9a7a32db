#!/usr/bin/env python
"""Keyframe-policy ablation on one CUDA GPU, fixed cadence against the
motion/covisibility-adaptive policy — the twin of the JAX package's
tools/ablate_keyframes.py.

`--scenario stopgo` writes (once) a stop-and-go city under
<data-root>/parking with `generate`: straights, two 90-degree turns and two
45-frame traffic stops (the reference's Malaga drive has exactly these),
`--frames` long, and reads it back through `Sequence("parking")`.
`--scenario headline` reads the 600-frame city bench_torch.py measures
(`Sequence("synthetic", path=--headline-root)`). Each scenario is rolled in
full under three policies, capacity 1024, seed 2023: `every3` (a keyframe
every 3rd frame), `adaptive` (with the `--min-baseline-ratio`,
`--min-covisibility` and `--max-gap` overrides) and `no-ba`. Each: a warm-up
rollout, then a timed one with the same draws.

The stop is what fixed cadence cannot survive in monocular BA: at zero
baseline every pushed keyframe shrinks the window's span toward zero, the
gauge pair degenerates, and scale drifts. The adaptive policy stops pushing
while the camera stands.

    python tools/ablate_keyframes_torch.py [--scenario both] [--frames 400]
    python tools/ablate_keyframes_torch.py --device cpu --scenario stopgo --frames 24

Each trial prints ATE, distinct keyframes (`state.last_kf_idx` after each
step), fallbacks (frames without pose_ok) and frames/s; its row also has the
keyframe pushes, those made while the camera stood still, and the steps it
stood. Then one JSON line with the card's name and power limit. Exits 1 if any
trial failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)

FRAMES, CAPACITY = 400, 1024


def stopgo_spec(frames: int):
    """The stop-and-go city: DEFAULT_SPEC's scene on a path with two turns
    and two 45-frame stops."""
    from vo_tpu_torch.data.city import PathSpec
    from vo_tpu_torch.data.synthetic import DEFAULT_SPEC

    return dataclasses.replace(
        DEFAULT_SPEC,
        num_frames=frames,
        path=PathSpec(
            segments=(
                ("straight", 40.0),
                ("turn", 90.0, 8.0),
                ("straight", 35.0),
                ("turn", -90.0, 8.0),
                ("straight", 30.0),
            ),
            stops=((70, 45), (240, 45)),
        ),
    )


def trials(min_baseline_ratio=None, min_covisibility=None, max_gap=None) -> dict:
    """The three policies, by the JAX tool's names."""
    from vo_tpu_torch.utils.config import BAConfig, VOConfig

    kw = {}
    if min_baseline_ratio is not None:
        kw["min_baseline_ratio"] = min_baseline_ratio
    if min_covisibility is not None:
        kw["min_covisibility"] = min_covisibility
    if max_gap is not None:
        kw["max_gap"] = max_gap
    return {
        "every3": VOConfig(capacity=CAPACITY,
                           ba=BAConfig(keyframe_mode="every", keyframe_every=3)),
        "adaptive": VOConfig(capacity=CAPACITY, ba=BAConfig(keyframe_mode="adaptive", **kw)),
        "no-ba": VOConfig(capacity=CAPACITY, ba=BAConfig(enabled=False)),
    }


def load(seq, dev, first: int = 0):
    """(K, frames first + 3.. stacked on the device, frame first, frame
    first + 2, the GT poses from frame first on)."""
    import numpy as np
    import torch

    imgs = torch.from_numpy(np.stack([seq.get_frame(i) for i in range(first, len(seq))]))
    imgs = imgs.to(dev)
    return (torch.as_tensor(seq.K, device=dev), imgs[3:], imgs[0], imgs[2],
            seq.gt_poses[first:])


def roll(state, imgs, K, cfg):
    """`vo_step` over `imgs`: (the StepOutputs stacked, last_kf_idx after
    each step)."""
    import torch

    from vo_tpu_torch.models.pipeline import StepOutput, vo_step

    outs, kf = [], []
    for img in imgs:
        state, out = vo_step(state, img, K, cfg)
        outs.append(out)
        kf.append(state.last_kf_idx)
    return StepOutput(*(torch.stack(f) for f in zip(*outs))), torch.stack(kf)


def run_scenario(K, imgs, img0, img2, gt, dev, configs: dict) -> list:
    """Each policy over the whole scenario: a warm-up, then a timed rollout
    with the same draws. One row a policy; `pushes_stopped` counts the
    keyframes pushed on the `stopped_steps`, the steps whose GT position is
    the previous frame's."""
    import numpy as np
    import torch

    from vo_tpu_torch.models.pipeline import bootstrap, rewinder

    pos = gt[2:3 + imgs.shape[0], :3, 3]
    stopped = (pos[1:] == pos[:-1]).all(axis=1)

    def measure(name, cfg):
        def trial():
            st, out = bootstrap(img0, img2, K, cfg, bench_torch.seeded(dev))
            rewind = rewinder(st)
            roll(st, imgs, K, cfg)  # warm-up
            rewind()
            bench_torch.sync(dev)
            t0 = time.perf_counter()
            outs, kf = roll(st, imgs, K, cfg)
            bench_torch.sync(dev)
            return out, outs, kf, time.perf_counter() - t0, st.last_kf_idx

        (out, outs, kf, dt, kf0), launches = common_torch.counting_launches(trial)
        ate = bench_torch.trajectory_errors(out.pose.cpu().numpy(), outs, gt)[0]
        kf_all = torch.cat([kf0.reshape(1), kf]).tolist()
        pushed = np.array([a != b for a, b in zip(kf_all, kf_all[1:])], dtype=bool)
        row = dict(ate_m=ate, keyframes=len(set(kf.tolist())), pushes=int(pushed.sum()),
                   pushes_stopped=int((pushed & stopped).sum()),
                   stopped_steps=int(stopped.sum()),
                   fallbacks=int((~outs.pose_ok).sum()), fps=imgs.shape[0] / dt,
                   steps=int(imgs.shape[0]),
                   finite=int(torch.isfinite(outs.pose).all(dim=(1, 2)).sum()),
                   frozen=int(outs.frozen.sum()),
                   k1=launches["corner_response_nms"], k2=launches["extract_patches"])
        print(f"{name:>10}: ATE {ate:7.3f} m   keyframes {row['keyframes']:4d}   "
              f"fallbacks {row['fallbacks']:3d}   fps {row['fps']:6.1f}", flush=True)
        return row

    return common_torch.run_variants(configs, measure)


def stopgo(data_root: str, frames: int, dev, configs: dict, first: int = 0) -> list:
    """The stop-and-go scenario: written under <data_root>/parking once, and
    rolled from frame `first` (bootstrap on frames first and first + 2)."""
    from vo_tpu_torch.data import Sequence
    from vo_tpu_torch.data.synthetic import generate

    generate(os.path.join(data_root, "parking"), stopgo_spec(frames), device=dev)
    return run_scenario(*load(Sequence("parking", path=data_root), dev, first), dev,
                        configs)


def headline(headline_root: str, dev, configs: dict) -> list:
    """The headline city, no stops."""
    from vo_tpu_torch.data import Sequence

    seq = Sequence("synthetic", path=headline_root, render_device=str(dev))
    return run_scenario(*load(seq, dev), dev, configs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--data-root", default="./data/stopgo")
    ap.add_argument("--headline-root", default="./data",
                    help="where the headline city is rendered once and read from")
    ap.add_argument(
        "--scenario", choices=["stopgo", "headline", "both"], default="both",
        help="stopgo: stop-and-go city (adaptive's home turf); headline: "
        "the default 600-frame no-stop sequence bench_torch.py measures",
    )
    ap.add_argument("--min-baseline-ratio", type=float, default=None)
    ap.add_argument("--min-covisibility", type=float, default=None)
    ap.add_argument("--max-gap", type=int, default=None)
    args = ap.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "ablate_keyframes_torch")
    if dev is None:
        return 2
    configs = trials(args.min_baseline_ratio, args.min_covisibility, args.max_gap)
    # The policies are compared step by step (`roll` reads each step's
    # keyframe index), so the step runs eagerly.
    line = {"tool": "ablate_keyframes_torch", "device": bench_torch.card_name(dev),
            "capacity": CAPACITY, "executor": "eager"}
    if args.scenario in ("stopgo", "both"):
        print(f"[stopgo] {args.frames} frames, two 45-frame stops, two 90-deg turns")
        line["stopgo"] = dict(frames=args.frames,
                              rows=stopgo(args.data_root, args.frames, dev, configs))
    if args.scenario in ("headline", "both"):
        print("[headline] DEFAULT_SPEC 600 frames, no stops (the bench_torch.py sequence)")
        line["headline"] = dict(rows=headline(args.headline_root, dev, configs))
    print(json.dumps(line))
    failed = any("error" in r for s in ("stopgo", "headline") if s in line
                 for r in line[s]["rows"])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
