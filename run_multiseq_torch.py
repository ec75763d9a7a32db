#!/usr/bin/env python
"""Multi-sequence VO evaluation on CUDA GPUs — the PyTorch/CUDA twin of
`run_multiseq.py`: its dataset lanes and `--sweep`, `--full`, `--multihost`
and `--seqpar-shards`.

The default mode reads one disk sequence a lane (`--dataset`, `--data-root`,
`--sequences`; vo_tpu_torch.data.Sequence), bootstraps each lane alone (seed
2023 + lane), stacks the frames of each lane's ping-pong frame plan into one
(steps, B, H, W) f32 tensor on the device and rolls all lanes through
`batched_vo_rollout` once to warm up and once timed. It prints
`multiseq_throughput` (aggregate frames/s, per-lane ATE over each lane's true
forward pass); `--sweep 1,2,4` replicates the first sequence B times and
prints `multiseq_scaling`. On one card the lanes roll in one process (the
mesh placement, `make_sharded_rollout`, is the multihost worker's).

    python run_multiseq_torch.py --dataset parking --data-root ./data \
        --sequences a,b,c,d,e,f --steps 40
    python run_multiseq_torch.py --dataset parking --data-root ./data --sweep 1,6

Renders six DISTINCT synthetic city sequences (varied seeds and paths, one
stop-and-go) on the device, bootstraps each lane on its own, stacks the
states and rolls them full-length in lockstep through ONE batched step
(`vo_tpu_torch.parallel.multiseq.batched_vo_rollout`, chunks of 64 frames);
reports per-lane ATE and aggregate frames/s, plus a distorted-lens lane run
on its own through `vo_rollout` (distortion coefficients are static in the
config).

    python run_multiseq_torch.py --full                      # 6 lanes x 600 frames
    python run_multiseq_torch.py --full --full-lanes city_lr,stopgo --full-frames 120
    python run_multiseq_torch.py --full --device cpu --full-frames 8 --full-lanes 2

`--full` prints one JSON line per lane and a final JSON report (metric,
lanes, batch, steps, agg_fps, device).

    python run_multiseq_torch.py --multihost 1,2          # a cluster of each size
    python run_multiseq_torch.py --seqpar-shards 2        # composed-window BA

`--multihost P,...` spawns a cluster of P worker ranks for each P
(`python -m vo_tpu_torch.parallel.multihost`, the lockstep rollout with
`--mh-lanes` lanes a rank) and prints each cluster's report and the
weak-scaling table. `--seqpar-shards N` spawns N ranks: rank 0 runs the
front-end with a composed BA window of 4N keyframes (`refine_in_step=False`)
and broadcasts the window at the end of every chunk; all ranks refine it with
`seqpar_ba_refine`, keyframe blocks sharded over them; rank 0 writes the
landmarks back by uid and applies the newest keyframe's rigid correction to
the live pose. It reports ATE with and without that back-end. Ranks use NCCL
when each has a card of its own and Gloo otherwise (`--backend` chooses);
every line says which.

On the card every rollout replays the step's CUDA graph, one a frame,
captured once per shape (vo_tpu_torch/models/graphed.py) and outside the
timed windows; `--no-graph` runs it eagerly, with the same results. The
JSON lines name the `executor` ("graphs" or "eager") and, in `graphs`, the
host syncs a step, the recoveries and keyframes counted on the device and
each runner's graphs with their nodes (null when eager).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

CHUNK = 64  # frames per `batched_vo_rollout` call; the state carries across
SEQPAR_CHUNK = 16  # frames between two refinements of the composed window
RANK_TIMEOUT_S = 900  # a cluster that takes longer is killed


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", choices=["kitti", "malaga", "parking"], default="kitti")
    p.add_argument("--data-root", default="./data")
    p.add_argument("--sequences", default="05",
                   help="comma-separated KITTI sequence ids (one per batch lane)")
    p.add_argument("--sweep", default="",
                   help="comma-separated batch sizes: replicate sequence 0 and "
                        "report aggregate fps per size")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--full", action="store_true",
                   help="the full-length multi-sequence accuracy evaluation")
    p.add_argument("--full-frames", type=int, default=600,
                   help="frames per lane")
    p.add_argument("--full-lanes", type=str, default="",
                   help="limit to N lanes (int) or a comma-separated lane-name "
                        "list (e.g. city_lr,stopgo); empty = all six")
    p.add_argument("--capacity", type=int, default=512)
    p.add_argument("--no-kernels", action="store_true",
                   help="route detection/LK through the plain PyTorch chains "
                        "instead of the CUDA kernels (fault isolation)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; fails without a GPU) or cpu, only when asked")
    p.add_argument("--no-graph", action="store_true",
                   help="run the step eagerly, op by op, instead of replaying its CUDA "
                        "graphs (the counterpart of jax.disable_jit)")
    p.add_argument("--multihost", default="",
                   help="comma-separated rank counts (e.g. 1,2): a cluster of "
                        "multihost worker ranks for each, then the weak-scaling table")
    p.add_argument("--mh-lanes", type=int, default=1, help="lanes a rank (multihost)")
    p.add_argument("--mh-steps", type=int, default=6)
    p.add_argument("--mh-capacity", type=int, default=128)
    p.add_argument("--mh-crop", default="",
                   help="HxW crop for the multihost workers (empty = their default)")
    p.add_argument("--mh-repeats", type=int, default=4,
                   help="timed rollout repeats a worker (the first is warm-up)")
    p.add_argument("--seqpar-shards", type=int, default=0,
                   help="composed-window BA inside a real rollout: W_eff = 4 x "
                        "shards keyframes, refined by seqpar_ba_refine over this "
                        "many ranks between chunks; reports ATE with and without")
    p.add_argument("--seqpar-steps", type=int, default=150,
                   help="rollout frames for --seqpar-shards")
    p.add_argument("--scale", type=float, default=1.0,
                   help="--multihost/--seqpar-shards: render the city at this "
                        "fraction of 640x480 (focal scaled alike), for CPU runs")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="--multihost/--seqpar-shards: default nccl when every "
                        "rank has a card of its own, else gloo")
    p.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    p.add_argument("--seqpar-rank", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def lane_poses(first_pose, step_poses) -> np.ndarray:
    """Identity (frame 0), the bootstrap pose, then the step poses."""
    return np.concatenate([
        np.stack([np.eye(4, dtype=np.float32), np.asarray(first_pose, np.float32)]),
        np.asarray(step_poses, np.float32),
    ])


def run_lockstep(seqs: dict, cfg, seed: int = 2023, adaptive=(), graph: bool = True):
    """Bootstrap every lane of `seqs` (name -> Sequence) alone with its own
    sampler (seed + lane index), stack the states and roll all lanes in
    lockstep over frames 3.. in chunks (replaying the step's CUDA graphs,
    captured before the clock starts; `graph=False`: eagerly). Returns
    (boot_poses (B, 4, 4), outs: StepOutput stacked to (N, B, ...), seconds
    of the rollout)."""
    import torch

    from vo_tpu_torch.models.graphed import capture_ahead
    from vo_tpu_torch.models.pipeline import StepOutput, bootstrap
    from vo_tpu_torch.parallel.multiseq import batched_vo_rollout, stack_states

    names = list(seqs)
    first = seqs[names[0]]
    dev = first.frames.device
    states = []
    for i, name in enumerate(names):
        seq = seqs[name]
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        st, _ = bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg, gen)
        states.append(st)
    boot_poses = torch.stack([st.pose for st in states]).cpu().numpy()
    batched = stack_states(states)
    batched = batched._replace(kf_adaptive=torch.tensor(
        [name in adaptive for name in names], device=dev))
    Ks = torch.stack([seqs[name].K for name in names])
    n_steps = min(seqs[name].frames.shape[0] for name in names) - 3
    images = torch.stack([seqs[name].frames[3:3 + n_steps] for name in names], dim=1)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    capture_ahead(batched, images, Ks, cfg, graph)
    outs = []
    sync()
    t0 = time.perf_counter()
    for lo in range(0, n_steps, CHUNK):
        batched, out = batched_vo_rollout(batched, images[lo:lo + CHUNK], Ks, cfg, graph)
        outs.append(out)
    sync()
    dt = time.perf_counter() - t0
    return boot_poses, StepOutput(*(torch.cat(f) for f in zip(*outs))), dt


def run_single(seq, cfg, seed: int, graph: bool = True):
    """One sequence through bootstrap + `vo_rollout` (the distorted lane),
    captured before the clock starts (`graph=False`: eagerly). Returns
    (boot_pose, outs, seconds)."""
    import torch

    from vo_tpu_torch.models.graphed import capture_ahead
    from vo_tpu_torch.models.pipeline import bootstrap, vo_rollout

    dev = seq.frames.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    st, _ = bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg, gen)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    capture_ahead(st, seq.frames[3:], seq.K, cfg, graph)
    sync()
    t0 = time.perf_counter()
    _, outs = vo_rollout(st, seq.frames[3:], seq.K, cfg, graph)
    sync()
    return st.pose.cpu().numpy(), outs, time.perf_counter() - t0


def lane_report(name: str, est: np.ndarray, gt: np.ndarray) -> dict:
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses

    ate = ate_rmse(positions_from_poses(est), positions_from_poses(gt))
    return {"lane": name, "ate_rmse_m": round(float(ate), 3),
            "finite": bool(np.isfinite(est).all())}


def run_batch(args, seq_ids, cfg, dev):
    """The dataset lanes `seq_ids`: bootstrapped alone (seed 2023 + lane),
    stacked, rolled `args.steps` steps in lockstep once to warm up and once
    timed, each from the bootstrapped states. Returns (aggregate frames/s,
    per-lane ATE or None, boot poses (B, 4, 4), step poses (N, B, 4, 4))."""
    import torch

    from vo_tpu_torch.data import Sequence
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses
    from vo_tpu_torch.models.pipeline import bootstrap, rewinder
    from vo_tpu_torch.parallel.multihost import frame_plan
    from vo_tpu_torch.parallel.multiseq import batched_vo_rollout, stack_states

    b = len(seq_ids)
    seqs = [Sequence(args.dataset, path=args.data_root, kitti_sequence=s) for s in seq_ids]
    plans = [frame_plan(len(seq), args.steps) for seq in seqs]
    decoded = {}  # path -> frame on the device: lanes that share a file decode it once

    def frame(seq, i):
        path = seq.frames[i]
        if path not in decoded:
            decoded[path] = torch.from_numpy(seq.get_frame(i)).to(dev)
        return decoded[path]

    K = torch.as_tensor(seqs[0].K, dtype=torch.float32, device=dev)
    Ks = K.expand(b, 3, 3).contiguous()
    states = [bootstrap(frame(seq, 0), frame(seq, 2), K, cfg,
                        torch.Generator(device=dev).manual_seed(2023 + i))[0]
              for i, seq in enumerate(seqs)]
    stack = torch.stack([torch.stack([frame(seq, plan[n]) for seq, plan in zip(seqs, plans)])
                         for n in range(args.steps)])  # (N, B, H, W)
    decoded.clear()
    rewinds = [rewinder(st) for st in states]

    def lanes():
        # The rollout draws from the lanes' samplers: rewind them, so the
        # warm-up and the timed rollout make the same draws.
        for rewind in rewinds:
            rewind()
        return stack_states(states)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    graph = not args.no_graph
    batched_vo_rollout(lanes(), stack, Ks, cfg, graph)  # warm-up (and capture)
    batched = lanes()
    sync()
    t0 = time.perf_counter()
    _, outs = batched_vo_rollout(batched, stack, Ks, cfg, graph)
    sync()
    dt = time.perf_counter() - t0
    boot = torch.stack([st.pose for st in states]).cpu().numpy()
    poses = outs.pose.cpu().numpy()

    # Per-lane ATE over the true forward pass (frames 3..len-1) that ran.
    ates = []
    for i, seq in enumerate(seqs):
        if seq.gt_poses is None:
            ates.append(None)
            continue
        fwd = min(len(seq) - 3, args.steps)
        est = lane_poses(boot[i], poses[:fwd, i])
        gt = seq.gt_poses[[0, 2] + list(range(3, 3 + fwd))]
        ates.append(round(float(ate_rmse(positions_from_poses(est),
                                         positions_from_poses(gt))), 5))
    return args.steps * b / dt, ates, boot, poses


def run_dataset(args) -> int:
    """The dataset lanes (`--sequences`) or the batch-size sweep (`--sweep`)."""
    import torch

    from vo_tpu_torch.models.graphed import summary as graph_summary
    from vo_tpu_torch.models.pipeline import ROLLED, executor_since
    from vo_tpu_torch.utils.config import DetectorConfig, KLTConfig, VOConfig

    if _no_cuda(args):
        return 2
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    plain = {}
    if args.no_kernels:
        plain = dict(detector=DetectorConfig(use_pallas=False),
                     klt=KLTConfig(use_pallas=False))
    cfg = VOConfig(capacity=args.capacity, **plain)
    device = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    rolled = dict(ROLLED)
    if args.sweep:
        rows = []
        base = None
        for b in [int(x) for x in args.sweep.split(",")]:
            row = dict(ROLLED)
            fps = run_batch(args, [args.sequences.split(",")[0]] * b, cfg, dev)[0]
            base = base or fps
            rows.append({"batch": b, "agg_fps": round(fps, 2),
                         "scaling": round(fps / base, 3), "executor": executor_since(row)})
            print(json.dumps(rows[-1]), flush=True)
        print(json.dumps({"metric": "multiseq_scaling", "rows": rows,
                          "executor": executor_since(rolled), "graphs": graph_summary()}))
        return 0
    seq_ids = args.sequences.split(",")
    fps, ates, _, _ = run_batch(args, seq_ids, cfg, dev)
    print(json.dumps({
        "metric": "multiseq_throughput",
        "batch": len(seq_ids),
        "agg_fps": round(fps, 2),
        "ate_rmse_m": ates,
        "executor": executor_since(rolled),
        "graphs": graph_summary(),
        "device": device,
    }))
    return 0


def run_full(args) -> int:
    import torch

    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models.graphed import summary as graph_summary
    from vo_tpu_torch.models.pipeline import ROLLED, executor_since
    from vo_tpu_torch.utils.config import DetectorConfig, KLTConfig, VOConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        print("run_multiseq_torch: no CUDA device visible (pass --device cpu to "
              "run on the CPU)", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    plain = {}
    if args.no_kernels:
        plain = dict(detector=DetectorConfig(use_pallas=False),
                     klt=KLTConfig(use_pallas=False))
    cfg = VOConfig(capacity=args.capacity, **plain)

    seqs = synthetic.multiseq_sequences(dev, args.full_frames, args.full_lanes)
    graph = not args.no_graph
    rolled = dict(ROLLED)
    boot, outs, dt = run_lockstep(seqs, cfg, adaptive=synthetic.ADAPTIVE_LANES, graph=graph)
    poses = outs.pose.cpu().numpy()  # (N, B, 4, 4)
    n_steps = poses.shape[0]
    lanes = []
    for b, (name, seq) in enumerate(seqs.items()):
        gt = seq.gt_poses[[0, 2] + list(range(3, 3 + n_steps))]
        lanes.append(lane_report(name, lane_poses(boot[b], poses[:, b]), gt))
        print(json.dumps(lanes[-1]), flush=True)
    batch = len(seqs)
    del seqs

    # Distorted-lens lane (config-static coefficients -> a run of its own).
    dseq = synthetic.render_sequence(synthetic.distorted_spec(args.full_frames), dev)
    dcfg = dataclasses.replace(cfg, dist=synthetic.DISTORTED_DIST)
    dboot, douts, _ = run_single(dseq, dcfg, seed=2030, graph=graph)
    dgt = dseq.gt_poses[[0, 2] + list(range(3, dseq.frames.shape[0]))]
    lanes.append(lane_report("distorted", lane_poses(dboot, douts.pose.cpu().numpy()), dgt))
    print(json.dumps(lanes[-1]), flush=True)

    print(json.dumps({
        "metric": "multiseq_full",
        "lanes": lanes,
        "batch": batch,
        "steps": int(n_steps),
        "agg_fps": round(batch * n_steps / dt, 2),
        "executor": executor_since(rolled),
        "graphs": graph_summary(),
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
    }))
    return 0


def _no_cuda(args) -> bool:
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("run_multiseq_torch: no CUDA device visible (pass --device cpu to "
              "run on the CPU)", file=sys.stderr)
        return True
    return False


def run_multihost(args) -> int:
    """Weak-scaling harness: for each rank count P, P worker ranks joined in
    one process group, `--mh-lanes` lanes each; global work grows with P.
    Ranks that share a card (more ranks than cards) measure nothing of
    scaling, and the table says so."""
    import torch

    from vo_tpu_torch.parallel import multihost

    if _no_cuda(args):
        return 2
    counts = [int(x) for x in args.multihost.split(",")]
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    extra = ["--lanes-per-device", str(args.mh_lanes), "--steps", str(args.mh_steps),
             "--capacity", str(args.mh_capacity), "--repeats", str(args.mh_repeats),
             "--scale", str(args.scale), "--device", args.device]
    if args.mh_crop:
        extra += ["--crop", args.mh_crop]
    if args.backend:
        extra += ["--backend", args.backend]
    rows = []
    for nproc in counts:
        rep = multihost.run_cluster(nproc, extra, timeout=RANK_TIMEOUT_S)
        rep["fps_per_process"] = round(rep["agg_fps"] / nproc, 3)
        rows.append(rep)
        print(json.dumps(rep), flush=True)
    base = rows[0]["fps_per_process"]
    table = [{"processes": r["num_processes"], "lanes": r["lanes_global"],
              "backend": r["backend"], "device": r["device"], "agg_fps": r["agg_fps"],
              "weak_scaling_eff": round(r["fps_per_process"] / base, 3)} for r in rows]
    report = {"metric": "multihost_weak_scaling", "rows": table}
    if cards and max(counts) > cards:
        report["note"] = (f"{max(counts)} ranks share {cards} card(s): the table "
                          "measures nothing of scaling")
    print(json.dumps(report))
    return 0


def seqpar_cluster(args) -> dict:
    """Spawn the `--seqpar-shards` ranks (this script with a hidden rank
    argument) and return rank 0's report; a failed rank raises."""
    from vo_tpu_torch.parallel import multihost
    from vo_tpu_torch.parallel.mesh import free_port

    cmd = [sys.executable, str(Path(__file__).resolve()), "--seqpar-shards",
           str(args.seqpar_shards), "--seqpar-steps", str(args.seqpar_steps),
           "--capacity", str(args.capacity), "--scale", str(args.scale),
           "--device", args.device, "--coordinator", f"localhost:{free_port()}"]
    if args.no_graph:
        cmd.append("--no-graph")
    if args.backend:
        cmd += ["--backend", args.backend]
    outs = multihost.launch(
        [cmd + ["--seqpar-rank", str(i)] for i in range(args.seqpar_shards)], RANK_TIMEOUT_S)
    return multihost.last_json(outs[0])


def run_seqpar(args) -> int:
    """Print rank 0's report; the exit code is its gate."""
    if _no_cuda(args):
        return 2
    try:
        report = seqpar_cluster(args)
    except RuntimeError as exc:
        print(f"run_multiseq_torch: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(report))
    return 0 if report["passed"] else 1


def run_seqpar_rank(args) -> int:
    """One rank of `--seqpar-shards`. Rank 0 runs the front-end twice over
    the default city: with no back-end, then with the composed window
    refined by all ranks at the end of every chunk in which the newest
    keyframe slot holds a keyframe."""
    import torch
    import torch.distributed as dist

    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses
    from vo_tpu_torch.geom.lie import pose_inverse
    from vo_tpu_torch.models.ba import BAWindow, empty_window
    from vo_tpu_torch.models.feature_table import STATE_TRIANGULATED
    from vo_tpu_torch.models.pipeline import ROLLED, bootstrap, executor_since, vo_rollout
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.parallel import multihost
    from vo_tpu_torch.parallel.mesh import broadcast, make_mesh
    from vo_tpu_torch.parallel.window_blocks import (
        gather_window_blocks,
        seqpar_ba_refine,
        shard_window_blocks,
    )
    from vo_tpu_torch.utils.config import BAConfig, VOConfig

    t_start = time.perf_counter()
    shards, rank = args.seqpar_shards, args.seqpar_rank
    dev = (torch.device("cpu") if args.device == "cpu"
           else torch.device("cuda", rank % torch.cuda.device_count()))
    backend = multihost.initialize(args.coordinator, shards, rank, dev, args.backend)
    mesh = make_mesh(n_data=1, n_model=shards, device=dev)
    W_eff = 4 * shards
    cfg = VOConfig(capacity=args.capacity, ba=BAConfig(window=W_eff, refine_in_step=False))

    seq = (synthetic.render_sequence(multihost.city_spec(args.scale), dev, args.seqpar_steps)
           if rank == 0 else None)
    K = broadcast(seq.K if rank == 0 else torch.zeros((3, 3), device=dev), mesh, "model")
    n = args.seqpar_steps
    refinements = 0

    def command(value: int) -> int:
        """Rank 0's next step for every rank: 1 refine, 0 skip, -1 done."""
        return int(broadcast(torch.tensor(value, device=dev), mesh, "model"))

    def refine(window: BAWindow) -> BAWindow:
        window = BAWindow(*(broadcast(x, mesh, "model") for x in window))
        block, _ = seqpar_ba_refine(mesh, shard_window_blocks(window, mesh), K,
                                    iters=cfg.ba.iters, damping=cfg.ba.damping,
                                    huber_px=cfg.ba.huber_px)
        return gather_window_blocks(block, mesh)

    def rollout(with_backend: bool):
        nonlocal refinements
        if rank != 0:  # the other ranks only refine
            while with_backend and command(0) == 1:
                refine(empty_window(W_eff, cfg.capacity, device=dev))
            return None
        state, _ = bootstrap(seq.frames[0], seq.frames[2], K, cfg,
                             torch.Generator(device=dev).manual_seed(2023))
        poses = []
        for c in range(3, n, SEQPAR_CHUNK):
            state, outs = vo_rollout(state, seq.frames[c:c + SEQPAR_CHUNK], K, cfg,
                                     not args.no_graph)
            poses.append(outs.pose)
            if with_backend and bool(state.window.kf_valid[-1]):
                command(1)
                refinements += 1
                old_last = state.window.kf_pose[-1].reshape(4, 4)
                refined = refine(state.window)
                tbl = state.table
                match = ((refined.lm_uid == tbl.uid) & refined.lm_valid
                         & (tbl.state == STATE_TRIANGULATED))
                tbl = tbl._replace(landmark=torch.where(match[:, None], refined.landmark,
                                                        tbl.landmark))
                # Rigid hand-off: the newest keyframe's correction moves the
                # live pose (the front-end consumes the back-end's estimate).
                delta = refined.kf_pose[-1].reshape(4, 4) @ pose_inverse(old_last)
                state = state._replace(table=tbl, window=refined, pose=delta @ state.pose)
        if with_backend:
            command(-1)
        est = torch.cat([torch.eye(4, device=dev)[None], torch.cat(poses)]).cpu().numpy()
        gt = seq.gt_poses[[0] + list(range(3, 3 + est.shape[0] - 1))]
        ate = float(ate_rmse(positions_from_poses(est), positions_from_poses(gt)))
        return ate, bool(np.isfinite(est).all())

    rolled = dict(ROLLED)
    try:
        plain = rollout(False)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        seqpar = rollout(True)
        dt = time.perf_counter() - t0
        dist.barrier()
    finally:  # a failed rank leaves at once; the launcher stops the others
        dist.destroy_process_group()
    if rank != 0:
        return 0
    (ate_plain, fin_plain), (ate_seqpar, fin_seqpar) = plain, seqpar
    finite = fin_plain and fin_seqpar
    print(json.dumps({
        "metric": "seqpar_window_rollout",
        "shards": shards,
        "world_size": shards,
        "backend": backend,
        "device": str(dev),
        "window_effective": W_eff,
        "frames": int(n),
        "frame": list(seq.frames.shape[1:]),
        "refinements": refinements,
        "ate_no_refine_m": round(ate_plain, 4),
        "ate_seqpar_m": round(ate_seqpar, 4),
        "finite": finite,
        "improvement_x": round(ate_plain / max(ate_seqpar, 1e-9), 2),
        "passed": bool(finite and ate_seqpar < ate_plain),
        "launches": dict(kernels.launch_counts),
        "executor": executor_since(rolled),
        "seconds_with_backend": round(dt, 3),
        "seconds": round(time.perf_counter() - t_start, 3),
    }), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.multihost:
        return run_multihost(args)
    if args.seqpar_rank is not None:
        return run_seqpar_rank(args)
    if args.seqpar_shards:
        return run_seqpar(args)
    if args.full:
        return run_full(args)
    return run_dataset(args)


if __name__ == "__main__":
    sys.exit(main())
