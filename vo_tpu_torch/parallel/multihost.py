"""Multi-process VO over torch.distributed — port of
vo_tpu/parallel/multihost.py.

The deployment shape for scale-out is N processes, one per card, each
driving its lanes, joined into one process group: the mesh "data" axis spans
every rank, each rank holds its lanes, and the only collectives are for
reporting (lanes are independent). This module is both the library
(`initialize`, `global_data_mesh`, `local_to_global`, `launch`) and a
runnable worker:

    python -m vo_tpu_torch.parallel.multihost --coordinator localhost:9731 \\
        --num-processes 2 --process-id 0 [--dist-ba | --seqpar-ba]

One worker per rank. `run_multiseq_torch.py --multihost 1,2` spawns the
workers of each cluster and prints the weak-scaling table. The backend is
NCCL when every rank has a card of its own and Gloo otherwise (ranks that
share a card, or the CPU); every JSON line says which, and on which device.

Modes, each checked against the single-device solver in the same process:
  * the lockstep rollout (default): `--lanes-per-device` lanes a rank over
    the synthetic city, or over a layout on disk (`--dataset parking
    --data-root D`, cropped by `--crop`), a cross-rank sum of the lanes,
    finite poses;
  * `--dist-ba`: landmark rows sharded over every rank (parallel/dist_ba.py);
  * `--seqpar-ba`: keyframe blocks sharded over every rank, W_eff = 4 a rank
    (parallel/window_blocks.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def initialize(coordinator: str, num_processes: int, process_id: int, device=None,
               backend: str | None = None) -> str:
    """Join the process group at `coordinator` (host:port) as rank
    `process_id` of `num_processes`. Returns the backend: `backend` if
    given, else NCCL when every rank has a card of its own, Gloo otherwise."""
    from vo_tpu_torch.parallel.mesh import init_cluster

    return init_cluster(f"tcp://{coordinator}", num_processes, process_id, device, backend)


def global_data_mesh(device=None):
    """("data", "model") mesh with every rank on "data"."""
    from vo_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_model=1, device=device)


def local_to_global(tree, mesh, batch_axis: int = 0):
    """The global batch from each rank's local, batch-leading tensors: the
    concatenation over the ranks of "data", in rank order, on every rank (a
    tensor, or a tuple / NamedTuple of them)."""
    from vo_tpu_torch.parallel.mesh import all_gather

    if isinstance(tree, tuple):
        parts = [local_to_global(x, mesh, batch_axis) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return all_gather(tree, mesh, "data", batch_axis)


def launch(cmds: list[list[str]], timeout: float, env: dict | None = None) -> list[str]:
    """Run one command per rank, all at once, from the repository root;
    returns their standard outputs. A rank that fails or outlives `timeout`
    kills the whole cluster (a dead rank must not leave its peers waiting on
    the rendezvous) and raises with what it printed."""
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cmd in cmds]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for rank, p in enumerate(procs):
            so, se = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(so)
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} exited {p.returncode}\n--- stdout ---\n"
                                   f"{so[-3000:]}\n--- stderr ---\n{se[-3000:]}")
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"a rank outlived {timeout:.0f} s: {exc.cmd}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def city_spec(scale: float = 1.0):
    """The default city at `scale` x 640x480, the focal length scaled alike
    (the same view; a small CPU run renders in a fraction of the time)."""
    from vo_tpu_torch.data import synthetic

    spec = synthetic.DEFAULT_SPEC
    return dataclasses.replace(spec, width=round(spec.width * scale),
                               height=round(spec.height * scale), focal=spec.focal * scale)


def frame_plan(n_imgs: int, steps: int) -> list:
    """The rollout's frame indices over a disk sequence: forward from frame
    3, back to frame 1, then 2 and forward again (run_multiseq's plan)."""
    order = list(range(3, n_imgs)) + list(range(n_imgs - 2, 0, -1)) + [1, 2]
    return (order * (steps // len(order) + 1))[:steps]


def last_json(stdout: str) -> dict:
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])


# ---------------------------------------------------------------------------
# Worker entry
# ---------------------------------------------------------------------------


def _parse(argv):
    p = argparse.ArgumentParser(description="multi-process VO worker")
    p.add_argument("--coordinator", default="localhost:9731")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--lanes-per-device", type=int, default=1)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--crop", default="128x256",
                   help="HxW crop of each frame (top left, K unchanged)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="render the city at this fraction of 640x480 (focal "
                        "scaled alike) before the crop: a small CPU run")
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "kitti", "malaga", "parking"],
                   help="synthetic: the default city rendered on the device; else a "
                        "layout under --data-root (vo_tpu_torch.data.Sequence)")
    p.add_argument("--data-root", default="./data")
    p.add_argument("--repeats", type=int, default=2,
                   help="timed rollout repeats (the first is warm-up)")
    p.add_argument("--dist-ba", action="store_true",
                   help="instead of the rollout, the landmark-sharded BA with "
                        "the mesh 'model' axis spanning every rank, against "
                        "the single-device solver")
    p.add_argument("--ba-landmarks-per-device", type=int, default=64)
    p.add_argument("--seqpar-ba", action="store_true",
                   help="instead of the rollout, the keyframe-sharded composed "
                        "window (W_eff = 4 a rank) against the single-device "
                        "solver on the same composed window")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default: cuda:{rank %% cards}) or cpu")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl when every rank has a card, else gloo")
    return p.parse_args(argv)


def _cluster_fields(args, backend: str, dev) -> dict:
    return {"num_processes": args.num_processes, "world_size": args.num_processes,
            "backend": backend, "device": str(dev)}


def _all_ranks(ok: bool, dev) -> bool:
    """True when `ok` holds on every rank of the cluster."""
    import torch
    import torch.distributed as dist

    bad = torch.tensor(0 if ok else 1, device=dev)
    dist.all_reduce(bad)
    return int(bad) == 0


def _ba_parity(ref, ref_errs, out, errs, rows: dict, tol: dict) -> dict:
    """Parity of a sharded result with the single-device one: the error
    traces, and each field in `rows` (name -> (sharded rows, reference rows))."""
    import numpy as np

    rt, at = tol["errs"]
    diff = {"errs": float(np.abs(errs.cpu().numpy() - ref_errs.cpu().numpy()).max())}
    match = {"errs": bool(np.allclose(errs.cpu().numpy(), ref_errs.cpu().numpy(),
                                      rtol=rt, atol=at))}
    for name, (got, want) in rows.items():
        g, w = got.cpu().numpy(), want.cpu().numpy()
        diff[name] = float(np.abs(g - w).max())
        match[name] = bool(np.allclose(g, w, rtol=tol[name][0], atol=tol[name][1]))
    # BA must have optimized something, not compared two no-ops.
    improved = float(ref_errs[-1]) < 0.7 * float(ref_errs[0])
    return {"err_first": round(float(ref_errs[0]), 4), "err_last": round(float(ref_errs[-1]), 4),
            "max_abs_diff": diff, "match": match, "improved": improved}


def _dist_ba_main(args, backend: str, dev) -> int:
    """Landmark rows of one window sharded over every rank; the camera-side
    normal equations ride the all-reduce. Every rank builds the same window
    (numpy) and computes the single-device reference itself."""
    import torch

    from vo_tpu_torch.models.ba import ba_refine
    from vo_tpu_torch.parallel.dist_ba import demo_window, distributed_ba_refine, shard_window
    from vo_tpu_torch.parallel.mesh import local_rows, make_mesh

    t0 = time.perf_counter()
    n = args.num_processes
    mesh = make_mesh(n_data=1, n_model=n, device=dev)
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], device=dev)
    L = args.ba_landmarks_per_device * n
    win = demo_window(L, num_keyframes=4, seed=11, device=dev)
    out, errs = distributed_ba_refine(mesh, shard_window(win, mesh), K, iters=4)
    ref, ref_errs = ba_refine(win, K, iters=4)
    rep = _ba_parity(ref, ref_errs, out, errs, {
        "pose": (out.kf_pose, ref.kf_pose),
        "landmarks": (out.landmark, local_rows(ref.landmark, mesh, "model")),
    }, {"errs": (1e-4, 1e-4), "pose": (1e-3, 2e-3), "landmarks": (1e-2, 5e-3)})
    ok = _all_ranks(all(rep["match"].values()) and rep["improved"], dev)
    if args.process_id == 0:
        print(json.dumps({"metric": "multihost_dist_ba", **_cluster_fields(args, backend, dev),
                          "landmarks": L, **rep, "all_ranks_ok": ok,
                          "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
    return 0 if ok else 1


def _seqpar_ba_main(args, backend: str, dev) -> int:
    """The composed window's keyframe blocks over every rank (W_eff = 4 a
    rank, at the per-rank memory of a 4-keyframe window): landmark sums ride
    the all-reduce and the Schur fill-in the all-gather. Every rank builds the
    same composed window and its own single-device reference."""
    import torch

    from vo_tpu_torch.models.ba import ba_refine
    from vo_tpu_torch.parallel.dist_ba import demo_window
    from vo_tpu_torch.parallel.mesh import local_rows, make_mesh
    from vo_tpu_torch.parallel.window_blocks import seqpar_ba_refine, shard_window_blocks

    t0 = time.perf_counter()
    n = args.num_processes
    mesh = make_mesh(n_data=1, n_model=n, device=dev)
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], device=dev)
    W_eff = 4 * n  # the window grows with the cluster
    win = demo_window(args.ba_landmarks_per_device, num_keyframes=W_eff, seed=7, device=dev)
    out, errs = seqpar_ba_refine(mesh, shard_window_blocks(win, mesh), K, iters=4)
    ref, ref_errs = ba_refine(win, K, iters=4)
    # Mid-trace errors compare loosely (the Huber weights amplify the f32
    # reassociation), poses strictly: the JAX package's verdict.
    rep = _ba_parity(ref, ref_errs, out, errs, {
        "pose": (out.kf_pose, local_rows(ref.kf_pose, mesh, "model")),
    }, {"errs": (5e-2, 1e-4), "pose": (1e-3, 2e-3)})
    ok = _all_ranks(all(rep["match"].values()) and rep["improved"], dev)
    if args.process_id == 0:
        print(json.dumps({"metric": "multihost_seqpar_ba", **_cluster_fields(args, backend, dev),
                          "window_effective": W_eff, **rep, "all_ranks_ok": ok,
                          "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
    return 0 if ok else 1


def _rollout_main(args, backend: str, dev) -> int:
    """Lockstep lanes over the "data" axis: the bootstrap is made once and
    sent from rank 0, every lane's sampler is seeded from its global lane
    index, each rank rolls its lanes with no collective in the step."""
    import torch

    from vo_tpu_torch.data import Sequence, synthetic
    from vo_tpu_torch.models.pipeline import ROLLED, bootstrap, executor_since, map_state
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.parallel.mesh import broadcast
    from vo_tpu_torch.parallel.multiseq import (
        gather_lanes,
        make_sharded_rollout,
        replicate_state,
        shard_batched_state,
    )
    from vo_tpu_torch.utils.config import VOConfig

    t_start = time.perf_counter()
    pid = args.process_id
    mesh = global_data_mesh(dev)
    lanes_local = args.lanes_per_device
    lanes_global = args.num_processes * lanes_local

    # The cross-rank sum: each rank's lanes promoted to the global batch.
    ones = local_to_global(torch.ones((lanes_local,), device=dev), mesh)
    gsum_ok = float(ones.sum()) == float(lanes_global)

    h, w = (int(v) for v in args.crop.split("x"))
    if args.dataset == "synthetic":
        seq = synthetic.render_sequence(city_spec(args.scale), dev, num_frames=args.steps + 3)
        frames, K = seq.frames[:, :h, :w].contiguous(), seq.K
        plan = list(range(3, args.steps + 3))
    else:  # a layout on disk, cropped (top left, K unchanged)
        seq = Sequence(args.dataset, path=args.data_root)
        plan = frame_plan(len(seq), args.steps)
        frames = torch.stack([torch.from_numpy(seq.get_frame(i)[:h, :w].copy())
                              for i in range(max(plan) + 1)]).to(dev)
        K = torch.as_tensor(seq.K, dtype=torch.float32, device=dev)
    cfg = VOConfig(capacity=args.capacity)
    st, _ = bootstrap(frames[0], frames[2], K, cfg,
                      torch.Generator(device=dev).manual_seed(2023))
    st = map_state(lambda x: broadcast(x, mesh, "data"), st, rng=st.rng, rec_rng=st.rec_rng)
    images = frames[plan, None].expand(-1, lanes_local, -1, -1).contiguous()
    Ks = K.expand(lanes_local, 3, 3).contiguous()
    rollout = make_sharded_rollout(mesh, cfg)

    def lanes():
        # Independent samplers, seeded from the global lane index: a lane's
        # result does not depend on the number of ranks.
        gens = [torch.Generator(device=dev).manual_seed(7 + i) for i in range(lanes_global)]
        return shard_batched_state(replicate_state(st, lanes_global, gens), mesh)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dt_best = None
    rolled = dict(ROLLED)
    for r in range(max(2, args.repeats)):
        states = lanes()
        kernels.reset_launch_counts()
        torch.distributed.barrier()
        sync()
        t0 = time.perf_counter()
        _, outs = rollout(states, images, Ks)
        sync()
        torch.distributed.barrier()
        dt = time.perf_counter() - t0
        if r > 0:
            dt_best = dt if dt_best is None else min(dt_best, dt)
    counts = dict(kernels.launch_counts)
    names = sorted(counts)
    all_counts = local_to_global(
        torch.tensor([[counts[k] for k in names]], device=dev), mesh).tolist()

    every = gather_lanes(outs, mesh)  # (N, B, ...), for reporting
    finite = bool(torch.isfinite(every.pose).all())
    ok = _all_ranks(finite and gsum_ok, dev)
    result = {
        "metric": "multihost_vo",
        **_cluster_fields(args, backend, dev),
        "lanes_global": lanes_global,
        "steps": args.steps,
        "frame": list(frames.shape[1:]),
        "agg_fps": round(args.steps * lanes_global / dt_best, 3),
        "gsum_ok": gsum_ok,
        "finite": finite,
        "pose_ok": int(every.pose_ok.sum()),
        "executor": executor_since(rolled),
        "launches": {k: [row[i] for row in all_counts] for i, k in enumerate(names)},
        "seconds": round(time.perf_counter() - t_start, 3),
        "process_id": pid,
    }
    if dev.type == "cuda" and args.num_processes > torch.cuda.device_count():
        result["note"] = "the ranks share one card: agg_fps says nothing of scaling"
    if pid == 0:
        print(json.dumps(result), flush=True)
    return 0 if ok else 1


def worker_main(argv=None) -> int:
    args = _parse(argv)
    import torch
    import torch.distributed as dist

    if args.device == "cuda" and not torch.cuda.is_available():
        print("multihost: no CUDA device visible (pass --device cpu)", file=sys.stderr)
        return 2
    if args.device == "cpu":
        dev = torch.device("cpu")
    else:  # one host: the local rank is the process id unless a launcher says
        local = int(os.environ.get("LOCAL_RANK", args.process_id))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    backend = initialize(args.coordinator, args.num_processes, args.process_id, dev,
                         args.backend)
    try:
        if args.dist_ba:
            return _dist_ba_main(args, backend, dev)
        if args.seqpar_ba:
            return _seqpar_ba_main(args, backend, dev)
        return _rollout_main(args, backend, dev)
    finally:
        dist.destroy_process_group()


def worker_cmd(coordinator: str, nproc: int, rank: int, extra=()) -> list[str]:
    """The command line of one worker rank (run from the repository root)."""
    return [sys.executable, "-m", "vo_tpu_torch.parallel.multihost",
            "--coordinator", coordinator, "--num-processes", str(nproc),
            "--process-id", str(rank), *extra]


def run_cluster(nproc: int, extra=(), timeout: float = 600, env: dict | None = None) -> dict:
    """Spawn `nproc` worker ranks on a free port and return rank 0's report."""
    from vo_tpu_torch.parallel.mesh import free_port

    coordinator = f"localhost:{free_port()}"
    outs = launch([worker_cmd(coordinator, nproc, i, extra) for i in range(nproc)],
                  timeout, env or dict(os.environ))
    return last_json(outs[0])


if __name__ == "__main__":
    sys.exit(worker_main())
