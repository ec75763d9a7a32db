#!/usr/bin/env python
"""Pinpoint the first non-finite value in a sift or harris run, one frame at
a time — the twin of the JAX package's tools/debug_sift_nan.py.

Steps `vo_step` (capacity 1024, seed 2023, `--tracker`) over the headline
city and reports each frame which state component is non-finite: the pose,
the BA window's keyframe poses, the table's triangulated landmarks or the
window's landmarks, which a chunked run (`--chunk`) cannot see. Scale telemetry
beside it (|t| of the pose, median landmark depth) shows an exponential
scale drift before it overflows float32. Stops at the first non-finite pose
(exit 1).

    python tools/debug_sift_nan_torch.py [--tracker sift] [--frames 90]
    python tools/debug_sift_nan_torch.py --tracker harris --dump-at 72
    python tools/debug_sift_nan_torch.py --device cpu --frames 8 --data-root D

`--dump-at N` writes the state before frame N is stepped as a checkpoint
(utils/checkpoint.py) to dbg_state_N.npz in the temporary directory. The
city is read through `Sequence("synthetic", path=--data-root)`. Ends in one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)

FRAMES, CAPACITY = 90, 1024


def _finite(x) -> bool:
    return bool(np.isfinite(x.cpu().numpy()).all())


def nonfinite_report(state, out) -> dict:
    """What of the stepped state is non-finite: the pose, the window's
    keyframe poses, the count of triangulated table slots and of valid
    window landmarks with a non-finite landmark, the first of these four
    components that is not finite (None when all are), and the scale
    telemetry."""
    from vo_tpu_torch.models.feature_table import STATE_TRIANGULATED

    pose_f = _finite(out.pose)
    win_f = _finite(state.window.kf_pose)
    lm = state.table.landmark.cpu().numpy()
    live = state.table.state.cpu().numpy() == STATE_TRIANGULATED
    lm_nan = int((~np.isfinite(lm).all(-1) & live).sum())
    wlm = state.window.landmark.cpu().numpy()
    wlv = state.window.lm_valid.cpu().numpy()
    wlm_nan = int((~np.isfinite(wlm).all(-1) & wlv).sum())
    bad = [name for name, ok in (("pose", pose_f), ("window_kf_pose", win_f),
                                 ("table_landmark", lm_nan == 0),
                                 ("window_landmark", wlm_nan == 0)) if not ok]
    return dict(
        pose_fin=pose_f, win_fin=win_f, tbl_lm_nan=lm_nan, win_lm_nan=wlm_nan,
        first_nonfinite=bad[0] if bad else None,
        t_norm=float(np.linalg.norm(out.pose.cpu().numpy()[:3, 3])),
        med_depth=float(np.nanmedian(np.abs(lm[live, 2]))) if live.any() else 0.0,
    )


def run(data_root: str, dev, tracker: str = "sift", frames: int = FRAMES,
        dump_at: int = 0) -> tuple[int, list]:
    """Step frames 3 .. frames-1. (exit code: 1 at the first non-finite
    pose, else 0; one report a frame)."""
    from vo_tpu_torch.models.pipeline import vo_step
    from vo_tpu_torch.utils.config import VOConfig

    cfg = VOConfig(capacity=CAPACITY, tracker=tracker)
    _, K, frame, state = common_torch.city_stepper(data_root, dev, cfg)
    rows = []
    for i in range(3, frames):
        if dump_at and i == dump_at:
            from vo_tpu_torch.utils.checkpoint import save_checkpoint

            path = os.path.join(tempfile.gettempdir(), f"dbg_state_{i}.npz")
            save_checkpoint(path, state, cfg)
            print(f"dumped pre-step state -> {path}")
        state, out = vo_step(state, frame(i), K, cfg)
        rep = dict(frame=i, ok=int(out.pose_ok), trk=int(out.num_tracked),
                   cand=int(out.num_candidates), inl=int(out.num_pnp_inliers),
                   tri=int(out.num_triangulated), **nonfinite_report(state, out))
        rows.append(rep)
        flag = "" if rep["first_nonfinite"] is None else "  <-- NONFINITE"
        print(
            f"f{i:3d} ok={rep['ok']} trk={rep['trk']:4d} cand={rep['cand']:4d} "
            f"inl={rep['inl']:4d} tri={rep['tri']:4d} "
            f"pose_fin={int(rep['pose_fin'])} win_fin={int(rep['win_fin'])} "
            f"tbl_lm_nan={rep['tbl_lm_nan']:3d} win_lm_nan={rep['win_lm_nan']:3d} "
            f"|t|={rep['t_norm']:.3e} med_depth={rep['med_depth']:.3e}{flag}",
            flush=True,
        )
        if not rep["pose_fin"]:
            print("pose:", out.pose.cpu().numpy())
            return 1, rows
    return 0, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tracker", default="sift")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--dump-at", type=int, default=0,
                    help="checkpoint the state BEFORE stepping this frame")
    ap.add_argument("--data-root", default="./data",
                    help="where the city is rendered once and read from")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    args = ap.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "debug_sift_nan_torch")
    if dev is None:
        return 2
    rc, rows = run(args.data_root, dev, args.tracker, args.frames, args.dump_at)
    print(json.dumps({"tool": "debug_sift_nan_torch", "device": bench_torch.card_name(dev),
                      "tracker": args.tracker, "frames": args.frames,
                      "first_nonfinite": next(({"frame": r["frame"],
                                                "component": r["first_nonfinite"]}
                                               for r in rows if r["first_nonfinite"]), None),
                      "rows": rows}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
