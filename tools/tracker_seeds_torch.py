#!/usr/bin/env python
"""How far one tracker mode's result moves with the RANSAC draw: the same
`run_vo_torch.py` run under several bootstrap seeds.

    python tools/tracker_seeds_torch.py --tracker harris --seeds 2023,1,2,3,4
    python tools/tracker_seeds_torch.py --tracker harris --seeds 2023 --no-kernels
    python tools/tracker_seeds_torch.py --tracker klt --seeds 2023,1,2,3
    python tools/tracker_seeds_torch.py --tracker klt --spec loop --pose-graph --seeds 1

Every run is that of the entry point (`run_vo_torch.run`, the 600-frame city at
640x480 or, with `--spec loop --pose-graph`, the 1,169-frame circuit with the
Sim(3) pose graph; capacity 1024, chunks of 16) with `run_vo_torch.BOOTSTRAP_SEED` set
to the seed; the state's sampler is seeded with it at bootstrap and every
later draw follows. Prints one JSON line per seed: the run's result line
plus the seed, the pose_ok count, the first frames that lost their pose and
`recoveries`, the frames on which the recovery ran (counted on the device
where the run replayed its graphs, else the frames that lost their pose:
the eager step runs it exactly there). Each seed captures its own graphs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tracker", choices=["klt", "harris", "sift"], default="harris")
    ap.add_argument("--seeds", default="2023,1,2,3,4", help="comma-separated bootstrap seeds")
    ap.add_argument("--max-frames", type=int, default=0, help="0 = all 600")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--spec", choices=["default", "loop"], default="default")
    ap.add_argument("--pose-graph", action="store_true")
    args = ap.parse_args(argv)

    import run_vo_torch
    from vo_tpu_torch.models import graphed

    base = ["--tracker", args.tracker, "--quiet", "--chunk", "16", "--device", args.device,
            "--max-frames", str(args.max_frames), "--spec", args.spec]
    base += (["--no-kernels"] if args.no_kernels else []) + (
        ["--pose-graph"] if args.pose_graph else [])
    for seed in (int(s) for s in args.seeds.split(",")):
        run_vo_torch.BOOTSTRAP_SEED = seed
        graphed.RUNNERS.clear()  # each seed's `graphs` counts its own frames
        rc, done = run_vo_torch.run(run_vo_torch.parse_args(base))
        if rc != 0:
            return rc
        lost = [s["frame"] for s in done.stats if not s["ok"]]
        loops = ([[lp["frame"], lp["matched_frame"]] for lp in done.backend.loops]
                 if done.backend is not None else None)
        graphs = done.result["graphs"]
        print(json.dumps({"seed": seed, "no_kernels": args.no_kernels, **done.result,
                          "recoveries": graphs["recoveries"] if graphs else len(lost),
                          "pose_ok": len(done.stats) - len(lost), "steps": len(done.stats),
                          "first_lost_frames": lost[:12], "loops": loops}), flush=True)
        del done
    return 0


if __name__ == "__main__":
    sys.exit(main())
