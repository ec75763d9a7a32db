#!/usr/bin/env python
"""Loop-closure evaluation of the PyTorch/CUDA port: BA-only against BA +
pose-graph back-end on the ~350 m / 1,169-frame closed circuit
(vo_tpu_torch/data/city.py LOOP_SPEC, a rounded rectangle whose tail
retraces the first 40 m) — the twin of tools/eval_loop.py over
`run_vo_torch.main`.

Monocular VO drifts over the circuit; the revisit lets the appearance loop
closure (models/keyframe_db.py) add graph constraints and the Sim(3) pose
graph (models/pose_graph.py) redistribute the drift. Both runs are re-scored
from their saved .npz files, independent of the run's own report.

Usage: python tools/eval_loop_torch.py [--device cuda|cpu] [--chunk 16] [--out-dir DIR]
Prints one JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--pg-every", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=0, help="0 = the whole circuit")
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--out-dir", default="out_torch",
                    help="where both runs' .npz files go (default: a git-ignored "
                         "directory; `out/` holds the JAX package's recorded runs)")
    args = ap.parse_args(argv)

    import numpy as np

    import run_vo_torch
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses

    common = [
        "--dataset", "synthetic", "--spec", "loop", "--device", args.device,
        "--chunk", str(args.chunk), "--max-frames", str(args.max_frames),
        "--capacity", str(args.capacity), "--quiet",
    ]
    print("[eval_loop] === BA-only run ===", flush=True)
    rc = run_vo_torch.main(common + ["--save-npz", f"{args.out_dir}/loop_ba.npz"])
    if rc != 0:
        return rc
    print("[eval_loop] === BA + pose-graph run ===", flush=True)
    rc = run_vo_torch.main(
        common + ["--pose-graph", "--pg-every", str(args.pg_every),
                  "--save-npz", f"{args.out_dir}/loop_pg.npz"])
    if rc != 0:
        return rc

    # Re-score both runs from the saved artifacts against the exact path.
    spec = synthetic.LOOP_SPEC
    gt = synthetic.make_path(spec.path, spec.num_frames)
    for name in ("loop_ba", "loop_pg"):
        z = np.load(f"{args.out_dir}/{name}.npz", allow_pickle=True)
        est, fid = z["poses"], z["frame_ids"]
        ate = ate_rmse(positions_from_poses(est), positions_from_poses(gt[fid]))
        row = {"run": name, "ate_rmse_m": round(float(ate), 3)}
        if "poses_raw" in z:
            raw = ate_rmse(positions_from_poses(z["poses_raw"]), positions_from_poses(gt[fid]))
            row["ate_pre_pg_m"] = round(float(raw), 3)
            row["loops"] = json.loads(str(z["loops"]))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
