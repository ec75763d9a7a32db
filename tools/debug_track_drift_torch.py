#!/usr/bin/env python
"""Isolate a turn-time triangulation failure, one frame at a time — the twin
of the JAX package's tools/debug_track_drift.py.

Steps `vo_step` (BA off, seed 2023) over the headline city and, from frame
`first` to `last`, triangulates each candidate's pixel track with the exact
GT poses at both ends (the frame the track started and this one). If the
residuals stay near 10 px, the tracks themselves (KLT drift) are the
problem; if they drop to noise, the estimated poses are. Per frame: the
median residual at the track's start and now, and by track age.

    python tools/debug_track_drift_torch.py [first last]      # 195 232, on cuda:0
    python tools/debug_track_drift_torch.py 6 10 --device cpu --data-root D

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

FIRST, LAST = 195, 232
AGES = [(1, 5), (5, 15), (15, 60), (60, 1000)]


def update_starts(uid_start: dict, prev_uids: set, table, frame: int) -> None:
    """Record `frame` as the start of every track that is new this frame
    (a uid not seen before) or restarted (outlier reset keeps the uid; a
    restarted track's start pixel is this frame's)."""
    uids = table.uid.cpu().numpy().tolist()
    for u in uids:
        if u not in prev_uids:
            uid_start[int(u)] = frame
    restarted = ((table.track_xy == table.xy).all(-1) & (table.state >= 0)).cpu().numpy()
    for idx in np.nonzero(restarted)[0]:
        uid_start[int(uids[idx])] = frame


def gt_residuals(table, K, gt_start, gt_now):
    """Triangulate every slot's track (start pixel, pixel now) with the GT
    poses at both ends: (reprojection error at the start, now), (slots,)."""
    from vo_tpu_torch.models.pipeline import _proj_matrix
    from vo_tpu_torch.ops.triangulate import reprojection_error, triangulate_dlt

    P_s = _proj_matrix(gt_start, K)
    P_n = _proj_matrix(gt_now, K)
    X = triangulate_dlt(P_s, P_n, table.track_xy, table.xy)
    return reprojection_error(P_s, X, table.track_xy), reprojection_error(P_n, X, table.xy)


def frame_report(table, K, gt, uid_start: dict, frame: int):
    """The medians of one frame over the candidates (None when there is
    none): residuals at GT poses at the start and now, and by track age."""
    import torch

    from vo_tpu_torch.models.feature_table import STATE_MATCHED

    cand = (table.state == STATE_MATCHED).cpu().numpy()
    if cand.sum() == 0:
        return None
    starts = np.array([uid_start.get(int(u), 0) for u in table.uid.cpu().numpy()], int)
    gt_t = torch.as_tensor(gt, dtype=torch.float32, device=K.device)
    r_s, r_n = (r.cpu().numpy() for r in gt_residuals(table, K, gt_t[starts], gt_t[frame]))
    age = frame - starts
    m = cand & np.isfinite(r_s)
    by_age = {}
    for lo, hi in AGES:
        sel = m & (age >= lo) & (age < hi)
        if sel.sum():
            by_age[f"{lo}-{hi}"] = (float(np.median(r_s[sel])), int(sel.sum()))
    return dict(frame=frame, candidates=int(m.sum()), med_r_start=float(np.median(r_s[m])),
                med_r_now=float(np.median(r_n[m])), by_age=by_age)


def run(data_root: str, dev, first: int = FIRST, last: int = LAST) -> list:
    """Step frames 3 .. last-1; a report a frame from `first` on."""
    from vo_tpu_torch.models.pipeline import vo_step
    from vo_tpu_torch.utils.config import BAConfig, VOConfig

    cfg = VOConfig(ba=BAConfig(enabled=False))
    seq, K, frame, state = common_torch.city_stepper(data_root, dev, cfg)
    uid_start = {int(u): 0 for u in state.table.uid.cpu().numpy()}
    rows = []
    for i in range(3, last):
        prev_uids = set(state.table.uid.cpu().numpy().tolist())
        state, _ = vo_step(state, frame(i), K, cfg)
        update_starts(uid_start, prev_uids, state.table, i)
        if i < first:
            continue
        rep = frame_report(state.table, K, seq.gt_poses, uid_start, i)
        if rep is None:
            continue
        rows.append(rep)
        print(f"f{i:3d} GT-pose med r_start={rep['med_r_start']:5.1f} "
              f"r_now={rep['med_r_now']:5.1f} | "
              + "  ".join(f"age{k}: {v[0]:5.1f}px n={v[1]}" for k, v in rep["by_age"].items()),
              flush=True)
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

    dev = common_torch.cuda_or_cpu(args.device, "debug_track_drift_torch")
    if dev is None:
        return 2
    rows = run(args.data_root, dev, args.first, args.last)
    print(json.dumps({"tool": "debug_track_drift_torch", "device": bench_torch.card_name(dev),
                      "first": args.first, "last": args.last, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
