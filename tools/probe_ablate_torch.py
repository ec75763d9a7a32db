#!/usr/bin/env python
"""KITTI-sized throughput probe under feature toggles, on one CUDA GPU — the
twin of the JAX package's tools/probe_ablate.py.

Each step feature (constant-velocity LK seeding, the two-tier lost-pose
recovery, the adaptive keyframe policy, BA) is toggled in turn, so every
frames/s point of the probe has a line-item owner. The probe is
`bench_torch.bench_kitti_probe` (bench.py's methodology): capacity 512,
bootstrap on frames 0 and 2, `--steps` frames ping-ponged over the sequence,
a warm-up, then the best of `--repeats` timed rollouts with the same draws.

The frames are KITTI 05's under `--kitti-root` (the `kitti/05` layout that
`vo_tpu_torch.data.Sequence` reads) where present. Otherwise they are the
first 6 frames of the synthetic city rendered at KITTI's size, 1226x370,
with KITTI 05's focal length 707.0912 (what chip_smoke.py's `bench` phase
probes), and the JSON line names the missing layout.

    python tools/probe_ablate_torch.py [--steps 40] [--repeats 3]
    python tools/probe_ablate_torch.py --device cpu --steps 3 --repeats 1

Each variant prints one JSON row: frames/s, pose_ok, finite and frozen
counts over the timed rollout, and the K1/K2 launches of the variant (its
bootstrap, warm-up and timed rollouts). Ends in one JSON line with the
card's name and power limit; exits 1 if any variant failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)

STEPS, REPEATS = 40, 3
KITTI_H, KITTI_W, KITTI_FOCAL = 370, 1226, 707.0912
CITY_FRAMES = 6  # the KITTI micro-dataset's length


def variants(base) -> dict:
    """The JAX tool's six configurations, by its names."""
    from vo_tpu_torch.utils.config import BAConfig, KLTConfig, RecoveryConfig

    return {
        "default": base,
        "no_recovery": dataclasses.replace(base, recovery=RecoveryConfig(enabled=False)),
        "no_predict_motion": dataclasses.replace(base, klt=KLTConfig(predict_motion=False)),
        "kf_adaptive": dataclasses.replace(base, ba=BAConfig(keyframe_mode="adaptive")),
        "no_ba": dataclasses.replace(base, ba=BAConfig(enabled=False)),
        "r1_like": dataclasses.replace(
            base,
            recovery=RecoveryConfig(enabled=False),
            klt=KLTConfig(predict_motion=False),
        ),
    }


def probe_frames(kitti_root: str, dev) -> tuple[list, object, str]:
    """(frames, K, where they came from): KITTI 05 where the layout is,
    else the city at 1226x370 and KITTI's focal length."""
    from vo_tpu_torch.data import Sequence, synthetic

    try:
        seq = Sequence("kitti", path=kitti_root, kitti_sequence="05")
    except FileNotFoundError as exc:
        spec = dataclasses.replace(synthetic.DEFAULT_SPEC, width=KITTI_W, height=KITTI_H,
                                   focal=KITTI_FOCAL)
        city = synthetic.render_sequence(spec, dev, CITY_FRAMES)
        return (list(city.frames), city.K,
                f"city {KITTI_W}x{KITTI_H}, focal {KITTI_FOCAL} (kitti absent: "
                f"{exc.filename or exc})")
    return [seq.get_frame(i) for i in range(len(seq))], seq.K, f"kitti/05 under {kitti_root}"


def probe(frames, K, dev, steps: int = STEPS, repeats: int = REPEATS) -> list:
    """One row a variant (see the module's docstring)."""
    import torch

    from vo_tpu_torch.utils.config import VOConfig

    def measure(name, cfg):
        (fps, runs), launches = common_torch.counting_launches(
            bench_torch.bench_kitti_probe, frames, K, dev, steps, cfg=cfg, repeats=repeats)
        timed = runs.timed
        row = dict(
            fps=round(fps, 2),
            pose_ok=int(timed.pose_ok.sum()),
            finite=int(torch.isfinite(timed.pose).all(dim=(1, 2)).sum()),
            frozen=int(timed.frozen.sum()) + int(runs.warm.frozen.sum()),
            steps=int(timed.pose.shape[0]),
            executor=runs.executor,
            k1=launches["corner_response_nms"],
            k2=launches["extract_patches"],
        )
        print(json.dumps({"variant": name, **row}), flush=True)
        return row

    return common_torch.run_variants(variants(VOConfig(capacity=bench_torch.KITTI_CAPACITY)),
                                    measure)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--kitti-root", default="./data",
                    help="data root holding kitti/05 (calib.txt, image_0/*.png)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    args = ap.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "probe_ablate_torch")
    if dev is None:
        return 2
    frames, K, source = probe_frames(args.kitti_root, dev)
    rows = probe(frames, K, dev, args.steps, args.repeats)
    print(json.dumps({
        "metric": "kitti_probe_ablation",
        "device": bench_torch.card_name(dev),
        "frames": source,
        "frame": list(frames[0].shape),
        "steps": args.steps,
        "repeats": args.repeats,
        "fps": {r["variant"]: r.get("fps") for r in rows},
        "rows": rows,
    }))
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
