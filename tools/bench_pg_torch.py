#!/usr/bin/env python
"""Pose-graph optimization at capacity on one CUDA GPU — the twin of the JAX
package's tools/bench_pg.py.

Builds a full graph (256 nodes by default: the pose-graph capacity of the
loop run) around a circle with per-step noise (seed 7) and 32 loop edges
spread around the circuit, then times `pg_optimize` (`--iters` GN
iterations) twice: the first call (cuBLAS/cuSOLVER start-up included) and
the second. Then the edge-sharded `distributed_pg_optimize` on the same graph
at one rank (a one-rank process group on a free localhost port: NCCL on the
card, Gloo on the CPU), timed after a warm-up call, and held bit for bit
against `pg_optimize` (at one rank the all-reduces return their input).

    python tools/bench_pg_torch.py [--nodes 256] [--iters 12]
    python tools/bench_pg_torch.py --device cpu --nodes 32   # on the CPU, only when asked

Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)

LOOP_EDGES = 32


def build_graph(n: int, dev):
    """n nodes around a circle (one step = a turn of 2 pi / n and 1 m
    forward, each perturbed by se3_exp(0.01 N(0, 1))), and 32 loop edges
    from node i = e n / 40 to the node half a circuit on (identity
    relative poses): tools/bench_pg.py's graph."""
    import torch

    from vo_tpu_torch.geom.lie import se3_exp
    from vo_tpu_torch.models.pose_graph import add_loop_edge, add_node, empty_pose_graph

    rng = np.random.default_rng(7)
    g = empty_pose_graph(num_nodes=n, num_loop_edges=LOOP_EDGES, device=dev)
    cur = torch.eye(4, dtype=torch.float32, device=dev)
    g = add_node(g, cur, 0)
    step = np.eye(4, dtype=np.float32)
    c, s = np.cos(2 * np.pi / n), np.sin(2 * np.pi / n)
    step[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    step[2, 3] = 1.0
    step = torch.as_tensor(step, device=dev)
    for k in range(1, n):
        xi = torch.as_tensor(0.01 * rng.standard_normal(6).astype(np.float32), device=dev)
        cur = cur @ (step @ se3_exp(xi))
        g = add_node(g, cur, k)
    eye = torch.eye(4, device=dev)
    for e in range(LOOP_EDGES):
        i = (e * n) // 40
        g = add_loop_edge(g, i, min(i + n // 2, n - 1), eye)
    return g


def bench(dev, nodes: int = 256, iters: int = 12) -> dict:
    import torch
    import torch.distributed as dist

    from vo_tpu_torch.models.pose_graph import pg_optimize
    from vo_tpu_torch.parallel import distributed_pg_optimize, make_mesh

    def timed(fn, *a, **k):
        bench_torch.sync(dev)
        t0 = time.perf_counter()
        out = fn(*a, **k)
        bench_torch.sync(dev)
        return out, time.perf_counter() - t0

    g = build_graph(nodes, dev)
    _, t_first = timed(pg_optimize, g, iters=iters)
    (out, errs), t_run = timed(pg_optimize, g, iters=iters)
    rec = {"metric": "pg_optimize_wall", "nodes": nodes, "loop_edges": LOOP_EDGES,
           "iters": iters, "first_s": t_first, "second_s": t_run,
           "err0": float(errs[0]), "err_last": float(errs[-1])}

    created = not dist.is_initialized()
    mesh = make_mesh(n_data=1, n_model=1, device=dev)
    try:
        distributed_pg_optimize(mesh, g, iters=iters)  # warm-up (NCCL's communicator)
        (dout, derrs), t_dist = timed(distributed_pg_optimize, mesh, g, iters=iters)
        rec.update(dist_s=t_dist, dist_ranks=dist.get_world_size(),
                   dist_backend=dist.get_backend(), dist_err_last=float(derrs[-1]),
                   dist_equal=bool(torch.equal(dout.node_pose, out.node_pose)
                                   and torch.equal(derrs, errs)))
    finally:
        if created:
            dist.destroy_process_group()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nodes", type=int, default=256)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    args = p.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "bench_pg_torch")
    if dev is None:
        return 2
    card = bench_torch.card_name(dev)
    print(f"[card] {card}")
    print(json.dumps({"tool": "bench_pg_torch", "device": card,
                      **bench(dev, args.nodes, args.iters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
