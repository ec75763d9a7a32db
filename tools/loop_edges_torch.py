#!/usr/bin/env python
"""How good the loop circuit's loop edges are: each verified loop edge of
`run_vo_torch.py --spec loop --pose-graph` held against the ground truth,
beside the run's ATE before and after the pose graph.

    python tools/loop_edges_torch.py --seeds 2023,1,2,3,4
    python tools/loop_edges_torch.py --seeds 2023 --device cpu --max-frames 300

Every run is that of the entry point (`run_vo_torch.run`, the 1,169-frame
circuit, chunks of 16) with `run_vo_torch.BOOTSTRAP_SEED` set to the seed.
An edge old_S_new (Sim(3), models/keyframe_db.py `verify_loop`) is scored
by the angle between its rotation and the true relative rotation of the
two keyframes, the angle between its translation and the true one, its
translation's length over the true length (in metres, through the map's
scale at the old keyframe: the pre-graph keyframe step over the true step),
and its scale over the ratio of the two keyframes' map scales. A perfect
edge scores 0, 0, 1, 1. Prints one JSON line per seed, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)


def _angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    c = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def edge_errors(loop_ij, loop_rel, loop_valid, node_frame, node_pose, gt) -> list:
    """[new frame, old frame, rotation deg, direction deg, length ratio,
    scale ratio] for each valid loop edge. `node_pose` (n, 16) are the
    graph's n keyframes' poses before the pose graph, `node_frame` (n,)
    their frames, `gt` maps a frame to its true (4, 4) pose."""
    pose = np.asarray(node_pose, np.float64).reshape(-1, 4, 4)
    frames = np.asarray(node_frame)

    def scale(k):  # the map's units per metre at keyframe k
        k = min(k, len(pose) - 2)
        est = np.linalg.inv(pose[k]) @ pose[k + 1]
        true = np.linalg.inv(gt(frames[k])) @ gt(frames[k + 1])
        return np.linalg.norm(est[:3, 3]) / np.linalg.norm(true[:3, 3])

    out = []
    for (i, j), rel, ok in zip(np.asarray(loop_ij), np.asarray(loop_rel), np.asarray(loop_valid)):
        if not ok:
            continue
        rel = np.asarray(rel, np.float64).reshape(4, 4)
        s = np.cbrt(np.linalg.det(rel[:3, :3]))
        true = np.linalg.inv(gt(frames[i])) @ gt(frames[j])
        R_err = (rel[:3, :3] / s).T @ true[:3, :3]
        rot = float(np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1.0, 1.0))))
        length = np.linalg.norm(rel[:3, 3]) / scale(i) / np.linalg.norm(true[:3, 3])
        out.append([int(frames[j]), int(frames[i]), rot, _angle_deg(rel[:3, 3], true[:3, 3]),
                    float(length), float(s / (scale(i) / scale(j)))])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="2023,1,2,3,4", help="comma-separated bootstrap seeds")
    ap.add_argument("--max-frames", type=int, default=0, help="0 = the whole circuit")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import run_vo_torch
    from vo_tpu_torch.models import graphed

    dev = common_torch.cuda_or_cpu(args.device, "loop_edges_torch")
    if dev is None:
        return 2
    card = bench_torch.card_name(dev)
    base = ["--spec", "loop", "--pose-graph", "--chunk", "16", "--quiet",
            "--device", args.device, "--max-frames", str(args.max_frames)]
    for seed in (int(s) for s in args.seeds.split(",")):
        run_vo_torch.BOOTSTRAP_SEED = seed
        graphed.RUNNERS.clear()
        rc, done = run_vo_torch.run(run_vo_torch.parse_args(base))
        if rc != 0:
            return rc
        be, fid = done.backend, list(done.frame_ids)
        g = {k: v.cpu().numpy() for k, v in be.graph._asdict().items()}
        n = be.n_nodes
        edges = edge_errors(g["loop_ij"], g["loop_rel"], g["loop_valid"], g["node_frame"][:n],
                            be._pre_opt_pose.cpu().numpy()[:n],
                            lambda f: done.seq.gt_poses[fid.index(int(f))])
        cols = np.asarray([e[2:] for e in edges]).reshape(-1, 4)
        print(json.dumps({
            "seed": seed, "device": card,
            "ate_raw_m": done.result.get("ate_rmse_m_pre_pg"),
            "ate_corrected_m": done.result.get("ate_rmse_m"),
            "loops": len(edges),
            "median": dict(zip(("rot_deg", "dir_deg", "length", "scale"),
                               np.median(cols, axis=0).tolist() if len(cols) else [])),
            "max_dir_deg": float(cols[:, 1].max()) if len(cols) else None,
            "edges": edges}), flush=True)
        del done
    return 0


if __name__ == "__main__":
    sys.exit(main())
