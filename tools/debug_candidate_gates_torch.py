#!/usr/bin/env python
"""Per-gate kill counts of candidate triangulation, one frame at a time —
the twin of the JAX package's tools/debug_candidate_gates.py.

Steps `vo_step` (BA off, seed 2023) over the headline city and, from frame
`first` to `last` (by default the first turn), replays the step's candidate
gates (models/pipeline.py, step 6) on the state after the step: how many
candidates pass the bearing gate, and how many of those the depth gate and
the two reprojection gates (now, at the track's start) kill. It shows which
quality gate starves landmark conversion when the view sweeps.

    python tools/debug_candidate_gates_torch.py [first last]   # 150 240, on cuda:0
    python tools/debug_candidate_gates_torch.py 6 10 --device cpu --data-root D

The city is read through `Sequence("synthetic", path=--data-root)`. Ends in
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)

FIRST, LAST = 150, 240


def gate_counts(state, K, cfg) -> dict:
    """The candidates of `state` through each gate: counts, and the median
    start-frame residual of those that pass the depth gate."""
    import torch

    from vo_tpu_torch.geom.lie import pose_inverse
    from vo_tpu_torch.models.feature_table import STATE_MATCHED
    from vo_tpu_torch.models.pipeline import _proj_matrix, _rays_world
    from vo_tpu_torch.ops.triangulate import reprojection_error, triangulate_dlt

    tcfg = cfg.triangulation
    t = state.table
    pose = state.pose
    Kinv = torch.linalg.inv(K)
    cand = (t.state == STATE_MATCHED).cpu().numpy()
    track_pose = t.track_pose.reshape(-1, 4, 4)
    ray_s = _rays_world(track_pose, Kinv, t.track_xy)
    ray_n = _rays_world(pose, Kinv, t.xy)
    ang = np.arccos(np.clip((ray_s * ray_n).sum(-1).cpu().numpy(), -1, 1))
    gate_b = cand & (ang >= tcfg.bearing_threshold)
    P_s = _proj_matrix(track_pose, K)
    P_n = _proj_matrix(pose, K)
    X = triangulate_dlt(P_s, P_n, t.track_xy, t.xy)
    T_sw = pose_inverse(track_pose)
    T_cw = pose_inverse(pose)
    z_s = ((T_sw[:, 2, :3] * X).sum(-1) + T_sw[:, 2, 3]).cpu().numpy()
    z_n = ((T_cw[2, :3] * X).sum(-1) + T_cw[2, 3]).cpu().numpy()
    r_n = reprojection_error(P_n, X, t.xy).cpu().numpy()
    r_s = reprojection_error(P_s, X, t.track_xy).cpu().numpy()
    fin = torch.isfinite(X).all(-1).cpu().numpy()
    kill_depth = gate_b & fin & ~(
        (z_s > tcfg.min_depth) & (z_n > tcfg.min_depth) & (z_n < tcfg.max_depth)
    )
    ok_depth = gate_b & fin & ~kill_depth
    return dict(
        cand=int(cand.sum()),
        pass_bear=int(gate_b.sum()),
        kill_depth=int(kill_depth.sum()),
        kill_rnow=int((ok_depth & (r_n >= tcfg.max_reproj_px)).sum()),
        kill_rstart=int((ok_depth & (r_s >= tcfg.max_reproj_px)).sum()),
        good=int((ok_depth & (r_n < tcfg.max_reproj_px)
                  & (r_s < tcfg.max_reproj_px)).sum()),
        med_r_start=float(np.median(r_s[ok_depth])) if ok_depth.any() else float("nan"),
    )


def run(data_root: str, dev, first: int = FIRST, last: int = LAST) -> list:
    """Step frames 3 .. last-1; the gate counts of each frame from `first`."""
    from vo_tpu_torch.models.pipeline import vo_step
    from vo_tpu_torch.utils.config import BAConfig, VOConfig

    cfg = VOConfig(ba=BAConfig(enabled=False))
    _, K, frame, state = common_torch.city_stepper(data_root, dev, cfg)
    rows = []
    for i in range(3, last):
        state, out = vo_step(state, frame(i), K, cfg)
        if i < first:
            continue
        c = dict(frame=i, ok=int(out.pose_ok), **gate_counts(state, K, cfg))
        rows.append(c)
        print(
            f"f{i:3d} ok={c['ok']} cand={c['cand']:3d} "
            f"pass_bear={c['pass_bear']:3d} kill_depth={c['kill_depth']:3d} "
            f"kill_rnow={c['kill_rnow']:3d} kill_rstart={c['kill_rstart']:3d} "
            f"good={c['good']:3d} med_r_start={c['med_r_start']:6.1f}px",
            flush=True,
        )
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("first", type=int, nargs="?", default=FIRST)
    ap.add_argument("last", type=int, nargs="?", default=LAST)
    ap.add_argument("--data-root", default="./data",
                    help="where the city is rendered once and read from")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    args = ap.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "debug_candidate_gates_torch")
    if dev is None:
        return 2
    rows = run(args.data_root, dev, args.first, args.last)
    print(json.dumps({"tool": "debug_candidate_gates_torch",
                      "device": bench_torch.card_name(dev), "first": args.first,
                      "last": args.last, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
