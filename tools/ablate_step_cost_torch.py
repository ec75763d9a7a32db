#!/usr/bin/env python
"""In-rollout step-cost ablation on one CUDA GPU: where do the milliseconds
of a frame go? The twin of the JAX package's tools/ablate_step_cost.py.

Parts timed alone (tools/profile_all_torch.py) miss what they cost inside
the rollout, so this attribution is differential: the SAME rollout (150
steps from frame 3 of the headline city, capacity 1024, seed 2023) with one
component dialled down at a time, and the frames/s and ms a frame of each
against `default`. Each variant: bootstrap on frames 0 and 2, a warm-up
rollout, then the best of `--repeats` timed rollouts with the same draws
(`bench_torch.warm_and_timed`).

    python tools/ablate_step_cost_torch.py [--steps 150] [--data-root ./data]
    python tools/ablate_step_cost_torch.py --reverse --again
    python tools/ablate_step_cost_torch.py --device cpu --steps 3 --repeats 1

The city is read through `Sequence("synthetic", path=--data-root)` (rendered
into <data-root>/synthetic the first time). Prints one line a variant (fps,
ms a frame, `delta` = default's ms minus the variant's: what turning the knob
down saves), then one JSON line with the card's name and power limit.
`--again` times `default` once more at the end and `--reverse` turns the
order of the others round, so a drift of the host inside one call can be
told from a knob's cost. A variant that fails prints its traceback and the
others still run; the tool then exits 1.
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

STEPS, REPEATS, CAPACITY = 150, 2, 1024


def variants(base) -> dict:
    """The JAX tool's nine configurations, by its names."""
    r = dataclasses.replace
    return {
        "default": base,
        "ba off": r(base, ba=r(base.ba, enabled=False)),
        "ba iters 5->1": r(base, ba=r(base.ba, iters=1)),
        "ba window 6->4": r(base, ba=r(base.ba, window=4)),
        "pnp hyp 256->64": r(base, pnp=r(base.pnp, num_hypotheses=64)),
        "pnp refine 10->3": r(base, pnp=r(base.pnp, refine_iters=3)),
        "klt iters 10->5": r(base, klt=r(base.klt, max_iters=5)),
        "no motion predict": r(base, klt=r(base.klt, predict_motion=False)),
        "recovery off": r(base, recovery=r(base.recovery, enabled=False)),
    }


def ablate(imgs, K, dev, steps: int = STEPS, repeats: int = REPEATS, reverse: bool = False,
           again: bool = False) -> list:
    """One row a variant (see the module's docstring): `default` first, the
    others in order (`reverse`: in reverse order), then with `again`
    `default` once more as "default again"."""
    import torch

    from vo_tpu_torch.models.pipeline import bootstrap
    from vo_tpu_torch.utils.config import VOConfig

    stack = imgs[3:3 + steps]
    n = stack.shape[0]
    base_ms = []

    def measure(name, cfg):
        def run():
            state, _ = bootstrap(imgs[0], imgs[2], K, cfg, bench_torch.seeded(dev))
            return bench_torch.warm_and_timed(state, stack, K, cfg, repeats)

        runs, launches = common_torch.counting_launches(run)
        ms = runs.seconds / n * 1e3
        delta = None if not base_ms else base_ms[0] - ms
        if not base_ms:
            base_ms.append(ms)
        print(f"{name:22s} {n / runs.seconds:7.1f} fps  {ms:6.2f} ms/frame"
              + ("" if delta is None else f"  delta {delta:+6.2f} ms"), flush=True)
        return dict(fps=n / runs.seconds, ms_a_frame=ms, delta_ms=delta, steps=n,
                    pose_ok=int(runs.timed.pose_ok.sum()),
                    finite=int(torch.isfinite(runs.timed.pose).all(dim=(1, 2)).sum()),
                    frozen=int(runs.timed.frozen.sum()), executor=runs.executor,
                    k1=launches["corner_response_nms"], k2=launches["extract_patches"])

    table = variants(VOConfig(capacity=CAPACITY))
    first, *rest = table
    order = {first: table[first], **{n: table[n] for n in (rest[::-1] if reverse else rest)}}
    if again:
        order[f"{first} again"] = table[first]
    return common_torch.run_variants(order, measure)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--reverse", action="store_true",
                    help="run the variants after `default` in reverse order")
    ap.add_argument("--again", action="store_true",
                    help="time `default` once more at the end (\"default again\"): a "
                         "drift inside the call shows as its delta")
    ap.add_argument("--data-root", default="./data",
                    help="where the city is rendered once and read from")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    args = ap.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "ablate_step_cost_torch")
    if dev is None:
        return 2
    print("loading frames...", flush=True)
    imgs, K, _ = bench_torch.read_city(args.data_root, dev, 3 + args.steps)
    print("loaded", flush=True)
    card = bench_torch.card_name(dev)
    print(f"device: {card}  ({imgs.shape[0] - 3} steps, {imgs.shape[2]}x{imgs.shape[1]}, "
          f"cap {CAPACITY})", flush=True)
    rows = ablate(imgs, K, dev, args.steps, args.repeats, args.reverse, args.again)
    print(json.dumps({"tool": "ablate_step_cost_torch", "device": card,
                      "frame": list(imgs.shape[1:]), "steps": imgs.shape[0] - 3,
                      "repeats": args.repeats, "reverse": args.reverse, "capacity": CAPACITY,
                      "rows": rows}))
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
