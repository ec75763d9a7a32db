"""The readings that a cell's limits are set from: the program's numbers
over many seeds, and the control's (check.numbers with control: the reference in the
program's place, in bfloat16) on the same answers' frames, each seed
through the cell's own window at the cell's own load. One process sets the
cell up once and runs every seed, printing a JSON line a seed and the
largest and smallest of each number at the end. The benchmark's own runs
never run this.

    python3 -m vobench.readings --workload <cell> --seeds 1,2,3 --seconds 30
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def read_seed(cell, setup, seed: int, seconds: float, raw: str | None = None) -> dict:
    """One seed: bootstrap, the window, the program's and the control's
    numbers, and the end-to-end figures for the record."""
    import torch

    from vobench import check, harness

    boot = harness.bootstrap(setup, seed)
    harness.warm_up(setup, boot, cell.traffic)
    win = harness.window(setup, boot, seed, seconds, cell.traffic)
    answers = check.collect(win, setup.n_lanes)
    t0 = time.perf_counter()
    both = check.numbers(setup, answers, control=True)
    program, control = both["program"], both["control"]
    check_s = time.perf_counter() - t0
    passes = []
    for p in answers:
        if p.complete:
            per = []
            for lane in range(setup.n_lanes):
                est, idx = check.trajectory(boot.poses[lane], p, lane, setup.boot_frames)
                per.append(float(np.sqrt(check.ate_sq_errors(est, setup.gt[lane][idx]).mean())))
            passes.append(per)
    if raw is not None:
        np.savez_compressed(f"{raw}-{seed}.npz", boot=boot.poses,
                            **{f"pose{i}": p.pose for i, p in enumerate(answers)},
                            **{f"ok{i}": p.pose_ok for i, p in enumerate(answers)},
                            **{f"frames{i}": p.frames for i, p in enumerate(answers)})
    row = {"seed": seed, "program": program, "control": control, "pass_ate_m": passes,
           "lane_frames": win.lane_frames, "window_s": win.seconds, "check_s": check_s,  # both sides
           "pose_ok_share": float(np.mean(np.concatenate([p.pose_ok.ravel()
                                                          for p in answers])))}
    del win
    if setup.frames.is_cuda:
        torch.cuda.synchronize()
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--raw", help="a path prefix: each seed's poses go to <raw>-<seed>.npz")
    args = p.parse_args(argv)

    import torch

    from vobench import harness, registry

    cell = registry.cell(args.workload)
    t0 = time.perf_counter()
    from vobench.run import FRAMES

    setup = harness.make_setup(cell.config, torch.device(args.device), FRAMES,
                               cell.traffic.get("copies", 1))
    print(f"[readings] {cell.name}: set up in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = read_seed(cell, setup, seed, args.seconds, args.raw)
        rows.append(row)
        print(json.dumps(row), flush=True)
    for side in ("program", "control"):
        for name in rows[0][side]:
            v = [r[side][name] for r in rows]
            print(f"[readings] {side} {name}: min {min(v)!r} max {max(v)!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
