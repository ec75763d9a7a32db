#!/usr/bin/env python
"""One tracker mode over the 600-frame city in BOTH packages on the CPU, side
by side: the JAX package (`vo_tpu`) and the port (`vo_tpu_torch`) from the
same rendered frames, same config, same seed number (the draws differ: a
`jax.random` key and a `torch.Generator` share no stream).

    JAX_PLATFORMS=cpu python tests/torch_reference_tracker_run.py \
        --tracker harris --frames 600 --seed 2023

Not a test (pytest does not collect it; at 640x480 the JAX half takes about
half an hour on four cores): it is the yardstick for a tracker mode whose
end-to-end figures follow the draw, where a single recorded run of the JAX
package on other hardware is no reference. Prints the per-window means of
tracked / triangulated / candidate / PnP-inlier / new-landmark counts and the
pose_ok frames of each package, then one JSON line with each package's ATE and
pose_ok count. Where `out/synth_<tracker>.npz` (the JAX package's recorded run
of that mode, with per-frame stats) is present, its windows are printed too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COUNTS = ("num_tracked", "num_triangulated", "num_candidates", "num_pnp_inliers",
          "num_new_landmarks")
RECORDED = dict(zip(COUNTS, ("tracked", "tri", "cand", "inl", "new")))
WINDOW = 25
CHUNK = 16


def _windows(name: str, counts: dict, first_frame: int) -> None:
    n = len(counts["pose_ok"])
    for a in range(0, n, WINDOW):
        means = [round(float(np.mean(counts[k][a:a + WINDOW]))) for k in COUNTS]
        print(f"{name:9s} frame {a + first_frame:4d}  {means}  "
              f"pose_ok {int(np.sum(counts['pose_ok'][a:a + WINDOW]))}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tracker", choices=["klt", "harris", "sift"], default="harris")
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seed", type=int, default=2023)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(args.threads)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from vo_tpu.models import pipeline as jp
    from vo_tpu.utils.config import VOConfig as JaxConfig
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses
    from vo_tpu_torch.models import pipeline as tp
    from vo_tpu_torch.utils.config import VOConfig

    seq = synthetic.render_sequence(synthetic.DEFAULT_SPEC, torch.device("cpu"), args.frames)
    gap = VOConfig().bootstrap.frame_gap
    first = gap + 1
    gt = seq.gt_poses[[0, gap] + list(range(first, args.frames))]
    counts, poses = {}, {}

    cfg = VOConfig(capacity=args.capacity, tracker=args.tracker)
    state, out = tp.bootstrap(seq.frames[0], seq.frames[gap], seq.K, cfg,
                              torch.Generator().manual_seed(args.seed))
    state, outs = tp.vo_rollout(state, seq.frames[first:], seq.K, cfg)
    counts["port"] = {k: getattr(outs, k).numpy().astype(int) for k in COUNTS + ("pose_ok",)}
    poses["port"] = np.concatenate([np.eye(4)[None], out.pose.numpy()[None], outs.pose.numpy()])

    jcfg = JaxConfig(capacity=args.capacity, tracker=args.tracker)
    K = jnp.asarray(seq.K.numpy())
    frames = seq.frames.numpy()
    jstate, jout = jp.bootstrap(jnp.asarray(frames[0]), jnp.asarray(frames[gap]), K, jcfg,
                                jax.random.PRNGKey(args.seed))
    rows = {k: [] for k in COUNTS + ("pose_ok",)}
    jposes = [np.eye(4)[None], np.asarray(jout.pose)[None]]
    for a in range(first, args.frames, CHUNK):
        blk = frames[a:a + CHUNK]
        n = len(blk)
        if n < CHUNK:  # one compiled chunk length; the padded outputs are dropped
            blk = np.concatenate([blk, np.repeat(blk[-1:], CHUNK - n, 0)])
        jstate, jouts = jp.vo_rollout(jstate, jnp.asarray(blk), K, jcfg)
        jposes.append(np.asarray(jouts.pose)[:n])
        for k in rows:
            rows[k].append(np.asarray(getattr(jouts, k)).astype(int)[:n])
    counts["reference"] = {k: np.concatenate(v) for k, v in rows.items()}
    poses["reference"] = np.concatenate(jposes)

    print(f"per {WINDOW} frames: {list(COUNTS)}")
    for name in ("port", "reference"):
        _windows(name, counts[name], first)
    recorded = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "out", f"synth_{args.tracker}.npz")
    if os.path.exists(recorded):
        stats = json.loads(str(np.load(recorded, allow_pickle=True)["stats"]))
        stats = stats[:args.frames - first]
        rec = {k: np.asarray([s[RECORDED[k]] for s in stats]) for k in COUNTS}
        rec["pose_ok"] = np.asarray([int(s["ok"]) for s in stats])
        _windows("recorded", rec, first)
    line = {"tracker": args.tracker, "frames": args.frames, "seed": args.seed, "device": "cpu"}
    for name in ("port", "reference"):
        line[name] = {
            "ate_rmse_m": float(ate_rmse(positions_from_poses(poses[name]),
                                         positions_from_poses(gt))),
            "pose_ok": int(counts[name]["pose_ok"].sum()),
            "steps": args.frames - first,
        }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
