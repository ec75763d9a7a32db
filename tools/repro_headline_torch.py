#!/usr/bin/env python
"""The headline with the hand-written kernels on and off, on one CUDA GPU —
the twin of the JAX package's tools/repro_headline.py.

Runs bench_torch.py's headline program (the city under
<data-root>/synthetic, capacity 1024, bootstrap on frames 0 and 2 with seed
2023, one `vo_rollout` over the rest, timed on the host clock with one
synchronize at the end; on the card it replays the step's CUDA graph,
one a frame, captured before the clock starts) with the LK patch-gather kernel (K2) on and off, and
with `--also-detect` the corner kernel (K1) off too, through the
`use_pallas` fields the port keeps for its CUDA kernels (None: the kernel on
a CUDA tensor; False: the plain PyTorch version), as `run_vo_torch.py
--no-kernels` sets them.

    python tools/repro_headline_torch.py [--also-detect] [--frames 600]
    python tools/repro_headline_torch.py --device cpu --frames 12

Each variant prints ATE, RPE, frames/s, its K1, K2 and LK solve launches,
the largest pose difference from `pallas_auto(default)`
(`bit_equal_to_default`: the poses equal the default's bit for bit) and the
sha256 of its poses (`poses_sha256`, the first 16 hex digits of the float32
array of every frame's pose), by which a route is pinned from one commit to
the next. `use_pallas` on the klt side routes K2, which equals its plain
version bit for bit, and LK's solve, which agrees with its plain version to
a few ulps, so `klt_pallas_off` follows the default to rounding and runs
the plain solve alone (the CPU runs the plain versions in every variant,
and there every row is bit-equal); K1 agrees only to rtol 1e-5, so with
detection off top-K ties may reorder. Ends in one JSON line with the card's
name and power limit; exits 1 if any variant failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)

CAPACITY = 1024


def variants(base, also_detect: bool) -> dict:
    """The JAX tool's variants, by its names."""
    r = dataclasses.replace
    out = {
        "pallas_auto(default)": base,
        "klt_pallas_off": r(base, klt=r(base.klt, use_pallas=False)),
    }
    if also_detect:
        out["detect_pallas_off"] = r(base, detector=r(base.detector, use_pallas=False))
        out["all_pallas_off"] = r(
            base,
            klt=r(base.klt, use_pallas=False),
            detector=r(base.detector, use_pallas=False),
        )
    return out


def repro(imgs, K, gt_poses, dev, also_detect: bool = True) -> list:
    """One row a variant (see the module's docstring)."""
    import torch

    from vo_tpu_torch.models.graphed import capture_ahead
    from vo_tpu_torch.models.pipeline import ROLLED, bootstrap, executor_since, vo_rollout
    from vo_tpu_torch.utils.config import VOConfig

    stack = imgs[3:]
    steps = stack.shape[0]
    default = []

    def measure(name, cfg):
        def run():
            state, out = bootstrap(imgs[0], imgs[2], K, cfg, bench_torch.seeded(dev))
            capture_ahead(state, stack, K, cfg)  # outside the clock
            bench_torch.sync(dev)
            t0 = time.perf_counter()
            _, outs = vo_rollout(state, stack, K, cfg)
            bench_torch.sync(dev)
            return out, outs, time.perf_counter() - t0

        rolled = dict(ROLLED)
        (out, outs, dt), launches = common_torch.counting_launches(run)
        boot = out.pose.cpu().numpy()
        est = bench_torch.step_poses(boot, outs)
        ate, t_rpe, r_rpe = bench_torch.trajectory_errors(boot, outs, gt_poses)
        if not default:
            default.append(est)
        res = {
            "fps": round(steps / dt, 2),
            "executor": executor_since(rolled),
            "ate_rmse_m": round(ate, 4),
            "rpe_trans_m": round(t_rpe, 5),
            "rpe_rot_deg": round(r_rpe * 57.29578, 5),
            "steps": int(steps),
            "pose_ok": int(outs.pose_ok.sum()),
            "finite": int(torch.isfinite(outs.pose).all(dim=(1, 2)).sum()),
            "k1": launches["corner_response_nms"],
            "k2": launches["extract_patches"],
            "lk": launches["lk_solve"],
            "max_pose_diff": float(abs(est - default[0]).max()),
            "bit_equal_to_default": bool((est == default[0]).all()),
            "poses_sha256": hashlib.sha256(est.tobytes()).hexdigest()[:16],
        }
        print(f"{name}: {res}", flush=True)
        return res

    return common_torch.run_variants(variants(VOConfig(capacity=CAPACITY), also_detect),
                                    measure)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--also-detect", action="store_true",
                    help="also toggle the detect-side kernel (K1)")
    ap.add_argument("--frames", type=int, default=None,
                    help="the city's first N frames (default: all)")
    ap.add_argument("--data-root", default="./data",
                    help="where the city is rendered once and read from")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    args = ap.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "repro_headline_torch")
    if dev is None:
        return 2
    imgs, K, seq = bench_torch.read_city(args.data_root, dev, args.frames)
    rows = repro(imgs, K, seq.gt_poses, dev, args.also_detect)
    out = {"tool": "repro_headline_torch", "device": bench_torch.card_name(dev),
           "frames": int(imgs.shape[0])}
    out.update({r.pop("variant"): r for r in rows})
    print(json.dumps(out))
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
