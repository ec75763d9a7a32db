#!/usr/bin/env python
"""Command-line entry point of the PyTorch/CUDA VO pipeline — the twin of
`run_vo.py` over `vo_tpu_torch`.

Headless and typed, flag for flag as `run_vo.py`: the device owns the
per-frame step; the host decodes frames, collects poses and stats, registers
pose-graph keyframes, writes checkpoints, reports ATE/RPE against ground
truth where the dataset has it, and writes the overlays and figures asked
for.

`--dataset kitti|malaga|parking` reads a layout under `--data-root`
(vo_tpu_torch.data.Sequence): frames come from the native decode-ahead ring
(csrc/frame_loader.cc) unless `--no-prefetch`, are gathered a chunk at a
time in pinned host memory and copied to the card without blocking.
`--dataset synthetic` renders the city on the device (no files). The JAX
package's `--dataset synthetic` reads the same city from disk; the port's way
to do that is `generate` (vo_tpu_torch.data.synthetic) into `D/parking`,
then `--dataset parking --data-root D`.

Examples:
  python run_vo_torch.py --dataset synthetic --quiet
  python run_vo_torch.py --dataset parking --data-root ./data --chunk 16 --quiet
  python run_vo_torch.py --dataset kitti --data-root ./data --kitti-sequence 05
  python run_vo_torch.py --tracker harris --max-frames 150
  python run_vo_torch.py --spec loop --pose-graph --chunk 16 --quiet
  python run_vo_torch.py --device cpu --max-frames 12 --capacity 128

Runs on `cuda` unless `--device cpu` is given, and exits 2 without a GPU
otherwise. On the card every chunk (every frame at `--chunk 1`) replays the
step's CUDA graph, one a frame, captured once (vo_tpu_torch/models/graphed.py),
with no host read inside the chunk; `--no-graph` runs the step eagerly, op
by op, with the same results. The final JSON line's `executor` names what
ran ("graphs" or "eager") and `graphs` what the graphs did (host syncs a
step, the frames on which the recovery and the keyframe branch ran, counted
on the device, each runner's graphs and their nodes; null when eager).
`--viz-dir` (cv2) and the PDF figures (matplotlib) exit 2 before the run
when their package is missing.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import Any, Callable, NamedTuple

TAG = "[vo_tpu_torch]"
BOOTSTRAP_SEED = 2023

# The figure flags and the package each needs (utils/viz.py imports them
# lazily, as the reference does).
FIGURE_PACKAGES = {"viz_dir": "cv2", "trajectory_pdf": "matplotlib",
                   "map_pdf": "matplotlib", "landmarks_pdf": "matplotlib"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=" ".join(__doc__.split("\n")[:2]))
    p.add_argument("--dataset", choices=["kitti", "malaga", "parking", "synthetic"],
                   default="synthetic")
    p.add_argument("--data-root", default="./data")
    p.add_argument("--kitti-sequence", default="05")
    p.add_argument("--increment", type=int, default=1)
    p.add_argument("--spec", choices=["default", "loop"], default="default",
                   help="synthetic sequence: the 600-frame city with two turns, or "
                        "the 1,169-frame closed circuit with a revisit")
    p.add_argument("--max-frames", type=int, default=0, help="0 = all")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    p.add_argument("--capacity", type=int, default=1024)
    p.add_argument("--tracker", choices=["klt", "harris", "sift"], default="klt",
                   help="front-end mode (ref tracker.py dispatch)")
    p.add_argument("--detector", choices=["shi_tomasi", "harris"], default="shi_tomasi")
    p.add_argument("--no-ba", action="store_true", help="disable windowed BA")
    # None -> defer to the BAConfig dataclass defaults (utils/config.py), so
    # tuning the library default cannot silently diverge from the CLI.
    p.add_argument("--ba-window", type=int, default=None)
    p.add_argument("--ba-every", type=int, default=None)
    p.add_argument("--kf-mode", choices=["adaptive", "every"], default="every",
                   help="keyframe policy: fixed cadence (every --ba-every frames) or "
                        "motion/covisibility-gated (adaptive: stop-and-go footage)")
    p.add_argument("--checkpoint", default="", help="write checkpoints here (.npz)")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--resume", default="", help="resume from a checkpoint (.npz)")
    p.add_argument("--viz-dir", default="",
                   help="write keypoint-overlay PNGs here (per-frame stepping; needs cv2)")
    p.add_argument("--trajectory-pdf", default="",
                   help="write the final trajectory figure (matplotlib)")
    p.add_argument("--map-pdf", default="", help="write the final 3-D point-cloud figure")
    p.add_argument("--landmarks-pdf", default="",
                   help="write the per-frame landmark-count history figure")
    p.add_argument("--save-npz", default="", help="save poses/stats to .npz")
    p.add_argument("--profile-dir", default="", help="torch.profiler trace directory")
    p.add_argument("--debug-validate", action="store_true",
                   help="run the feature-table invariant validator every frame")
    p.add_argument("--chunk", type=int, default=1,
                   help="frames per `vo_rollout` chunk (1 = per-frame stepping; >1 = "
                        "one fetch per chunk)")
    p.add_argument("--no-graph", action="store_true",
                   help="run the step eagerly, op by op, instead of replaying its CUDA "
                        "graphs (the counterpart of jax.disable_jit)")
    p.add_argument("--no-prefetch", action="store_true",
                   help="decode disk frames in the loop instead of the native "
                        "decode-ahead ring")
    p.add_argument("--no-kernels", action="store_true",
                   help="route detection/LK through the plain PyTorch chains instead "
                        "of the CUDA kernels (fault isolation)")
    p.add_argument("--pose-graph", action="store_true",
                   help="long-term pose-graph back-end with appearance loop closure "
                        "(keyframe DB + Sim(3) graph GN); the global trajectory is "
                        "re-anchored after optimization")
    p.add_argument("--pg-every", type=int, default=8,
                   help="frames between pose-graph keyframes")
    p.add_argument("--pg-nodes", type=int, default=256,
                   help="pose-graph capacity; older keyframes are culled by "
                        "chain-span score when full")
    p.add_argument("--pg-min-frame-gap", type=int, default=100)
    # 0.95: on the loop circuit genuine revisit edges retrieve at >= 0.978
    # while a false candidate that survives geometric verification retrieves
    # at 0.925, and one false Sim(3) edge bends the whole trajectory.
    p.add_argument("--pg-min-similarity", type=float, default=0.95)
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


class Run(NamedTuple):
    """What a run leaves behind besides its JSON line."""

    result: dict  # the final JSON line's object
    poses: Any  # (F, 4, 4) numpy, pose-graph corrected where a back-end ran
    poses_raw: Any  # (F, 4, 4) before the pose graph, or None
    frame_ids: list
    stats: list  # one dict per step
    state: Any  # the final VOState
    backend: Any  # the PoseGraphBackend, or None
    seq: Any  # the RenderedSequence, or the disk data.Sequence


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class DiskFrames:
    """The frames of a disk `Sequence` on the device, a chunk at a time:
    decoded by the native ring (`seq.prefetch`) or in the loop, gathered in
    one host buffer (pinned for a card) and copied with `non_blocking`. The
    buffer is refilled only once the previous copy has landed. `wait_s`
    counts the seconds the loop spent waiting on decoded frames."""

    def __init__(self, seq, dev, chunk: int, prefetch: bool = True):
        import torch

        self.seq, self.dev, self.chunk = seq, dev, chunk
        self.prefetch = prefetch
        self.ring = None
        self.native_ring = False
        self.wait_s = 0.0
        h, w = seq.get_frame(0).shape
        self.host = torch.empty((chunk, h, w), dtype=torch.float32,
                                pin_memory=dev.type == "cuda")
        self.copied = None  # the CUDA event of the last copy out of `host`

    def one(self, i: int):
        """Frame i alone (the bootstrap pair), decoded in the loop."""
        import torch

        return torch.from_numpy(self.seq.get_frame(i)).to(self.dev)

    def start(self, first: int) -> None:
        """Frames first, first+1, ... come next, in order (the ring decodes
        up to two chunks ahead; without the native library `seq.prefetch`
        decodes each frame when it is asked for)."""
        from vo_tpu_torch.data.native_loader import FramePrefetcher

        self.first = first
        if self.prefetch:
            self.ring = self.seq.prefetch(ring=max(8, 2 * self.chunk), start=first)
            self.native_ring = isinstance(self.ring, FramePrefetcher)

    def take(self, i: int, n: int):
        """Frames i..i+n-1 as an (n, H, W) f32 tensor on the device."""
        import torch

        if self.copied is not None:
            self.copied.synchronize()
        t0 = time.perf_counter()
        for k in range(n):
            out = self.host[k].numpy()
            if self.ring is not None:
                self.ring.get(i + k - self.first, out=out)
            else:
                out[...] = self.seq.get_frame(i + k)
        self.wait_s += time.perf_counter() - t0
        if self.dev.type != "cuda":
            return self.host[:n].clone()
        imgs = self.host[:n].to(self.dev, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        return imgs

    def close(self) -> None:
        if self.ring is not None:
            self.ring.close()


def run(args, observer: Callable | None = None) -> tuple[int, Run | None]:
    """Drive one sequence as `args` (a `parse_args` namespace) says. Returns
    (exit code, Run). `observer(frame, state, backend)` is called after each
    chunk (each frame at --chunk 1), after the pose-graph keyframe and the
    checkpoint of that frame."""
    import numpy as np
    import torch

    for flag, package in FIGURE_PACKAGES.items():
        if getattr(args, flag):
            try:
                importlib.import_module(package)
            except ImportError:
                print(f"run_vo_torch: --{flag.replace('_', '-')} needs the {package} "
                      "package, which is not installed", file=sys.stderr)
                return 2, None
    if args.device == "cuda" and not torch.cuda.is_available():
        print("run_vo_torch: no CUDA device visible (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 2, None
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")

    from vo_tpu_torch.data import Sequence, synthetic
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses, rpe
    from vo_tpu_torch.models.feature_table import STATE_TRIANGULATED
    from vo_tpu_torch.models.graphed import summary as graph_summary
    from vo_tpu_torch.models.pipeline import (
        ROLLED,
        StepOutput,
        bootstrap,
        executor_since,
        vo_rollout,
    )
    from vo_tpu_torch.utils import viz
    from vo_tpu_torch.utils.checkpoint import load_backend, load_checkpoint, save_checkpoint
    from vo_tpu_torch.utils.config import BAConfig, DetectorConfig, KLTConfig, VOConfig

    disk = args.dataset != "synthetic"
    if disk:
        seq = Sequence(args.dataset, path=args.data_root, increment=args.increment,
                       kitti_sequence=args.kitti_sequence)
        total = len(seq)
    else:
        spec = synthetic.LOOP_SPEC if args.spec == "loop" else synthetic.DEFAULT_SPEC
        total = spec.num_frames
    n_frames = total if args.max_frames <= 0 else min(args.max_frames, total)
    cfg = VOConfig(
        capacity=args.capacity,
        tracker=args.tracker,
        detector=DetectorConfig(
            method=args.detector,
            use_pallas=False if args.no_kernels else None,
        ),
        klt=KLTConfig(use_pallas=False if args.no_kernels else None),
        ba=BAConfig(enabled=not args.no_ba, keyframe_mode=args.kf_mode,
                    **{k: v for k, v in (("window", args.ba_window),
                                         ("keyframe_every", args.ba_every))
                       if v is not None}),
    )
    gap = cfg.bootstrap.frame_gap
    if n_frames <= gap:
        print(f"need more than {gap} frames, got {n_frames}", file=sys.stderr)
        return 2, None
    chunk = max(1, args.chunk)
    if chunk > 1 and (args.viz_dir or args.debug_validate):
        print(f"{TAG} --viz-dir/--debug-validate need per-frame stepping; falling back "
              "to --chunk 1")
        chunk = 1

    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if disk:
        K = torch.as_tensor(seq.K, dtype=torch.float32, device=dev)
        frames = DiskFrames(seq, dev, chunk, prefetch=not args.no_prefetch)
        print(f"{TAG} {args.dataset}: {n_frames} frames under {args.data_root}, "
              f"device={dev_name}")
    else:
        t_render = time.time()
        seq = synthetic.render_sequence(spec, dev, n_frames)
        _sync(dev)
        K = seq.K
        print(f"{TAG} {args.dataset}/{args.spec}: {n_frames} frames rendered in "
              f"{time.time() - t_render:.1f}s, device={dev_name}")

    profiler = None
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()

    t_start = time.time()
    if args.resume:
        state, cfg, traj, fids = load_checkpoint(args.resume, dev)
        frame_ids = [int(f) for f in fids] if fids is not None else []
        poses = list(traj) if traj is not None else []
        start_frame = int(state.frame_idx) + 1
        print(f"{TAG} resumed from {args.resume} at frame {start_frame - 1}")
    else:
        first, second = ((frames.one(0), frames.one(gap)) if disk
                         else (seq.frames[0], seq.frames[gap]))
        state, out = bootstrap(
            first, second, K, cfg,
            torch.Generator(device=dev).manual_seed(BOOTSTRAP_SEED),
        )
        _sync(dev)
        t_boot = time.time() - t_start
        print(
            f"{TAG} bootstrap(0,{gap}) in {t_boot:.1f}s: "
            f"tracked={int(out.num_tracked)} landmarks={int(out.num_triangulated)} "
            f"ok={bool(out.pose_ok)}"
        )
        frame_ids = [0, gap]
        poses = [np.eye(4, dtype=np.float32), out.pose.cpu().numpy()]
        start_frame = gap + 1
    stats: list[dict] = []
    t_loop = time.time()
    first_time = 0.0
    first_i = start_frame
    fps_meter = viz.FpsMeter()
    if disk:
        frames.start(start_frame)

    backend = None
    next_pg = start_frame
    if args.pose_graph:
        from vo_tpu_torch.models.backend import BackendConfig, PoseGraphBackend

        if args.resume:
            backend = load_backend(args.resume, dev)
            if backend is not None:
                last_kf = int(backend.graph.node_frame.max())
                next_pg = max(start_frame, last_kf + args.pg_every)
                print(
                    f"{TAG} pose-graph back-end resumed: "
                    f"{backend.n_nodes} nodes, {backend.n_loops} loop(s)"
                )
        if backend is None:
            backend = PoseGraphBackend(
                K,
                BackendConfig(
                    nodes=args.pg_nodes,
                    min_frame_gap=args.pg_min_frame_gap,
                    min_similarity=args.pg_min_similarity,
                ),
            )
    pg_seconds = 0.0

    def maybe_pose_graph(i, img):
        """Register frame i (`img` on the device) as a pose-graph keyframe if
        its cadence is due (off the per-frame path, once per pg_every
        frames)."""
        nonlocal next_pg, pg_seconds
        if backend is None or i < next_pg:
            return
        next_pg = i + args.pg_every
        t0 = time.time()
        info = backend.on_keyframe(img, state.pose, state.table, i)
        pg_seconds += time.time() - t0
        if info and not args.quiet:
            print(
                f"{TAG} LOOP closed: frame {info['frame']} <-> "
                f"{info['matched_frame']} (sim {info['similarity']:.2f}, "
                f"{info['inliers']} inliers)"
            )

    def record(i, out, dt):
        """`out`: one frame's StepOutput as numpy values."""
        frame_ids.append(i)
        poses.append(np.asarray(out.pose))
        stats.append(
            dict(frame=i, dt=dt, ok=bool(out.pose_ok),
                 tracked=int(out.num_tracked), tri=int(out.num_triangulated),
                 cand=int(out.num_candidates), inl=int(out.num_pnp_inliers),
                 new=int(out.num_new_landmarks), frozen=bool(out.frozen))
        )
        if not args.quiet:
            tag = "" if bool(out.pose_ok) else (
                "  [POSE FROZEN]" if bool(out.frozen) else "  [POSE FALLBACK]"
            )
            print(f"{TAG} frame {i:5d} {fps_meter.text()}  {viz.hud_text(out)}" + tag)

    def maybe_checkpoint(i):
        if args.checkpoint and (i - first_i + 1) % args.checkpoint_every < chunk:
            save_checkpoint(args.checkpoint, state, cfg,
                            trajectory=poses, frame_ids=frame_ids,
                            backend=backend)
            if not args.quiet:
                print(f"{TAG} checkpoint @ frame {i} -> {args.checkpoint}")

    def to_host(outs):
        return StepOutput(*(f.cpu().numpy() for f in outs))

    i = start_frame
    rolled = dict(ROLLED)
    while i < n_frames:
        n = min(chunk, n_frames - i)
        imgs = frames.take(i, n) if disk else seq.frames[i:i + n]
        t0 = time.time()
        # One `vo_rollout` and one fetch per chunk (a frame at --chunk 1);
        # the tail chunk is simply shorter.
        state, outs = vo_rollout(state, imgs, K, cfg, graph=not args.no_graph)
        outs_np = to_host(outs)  # the copy waits for the device
        dt = time.time() - t0
        if i == first_i:
            first_time = dt
        for k in range(n):
            record(i + k, StepOutput(*(f[k] for f in outs_np)), dt / n)
            fps_meter.tick()
        last = i + n - 1
        maybe_pose_graph(last, imgs[n - 1])
        maybe_checkpoint(last)  # after the pose graph: the checkpoint includes it
        if args.debug_validate:
            from vo_tpu_torch.models.feature_table import debug_validate

            violations = debug_validate(state.table)
            if violations:
                raise AssertionError(f"frame {last}: invariants violated: {violations}")
        if args.viz_dir:
            from vo_tpu_torch.data import png

            tab = state.table
            rgb = viz.keypoint_overlay(imgs[0].cpu().numpy(), tab.xy.cpu().numpy(),
                                       tab.state.cpu().numpy(), tab.track_xy.cpu().numpy())
            os.makedirs(args.viz_dir, exist_ok=True)
            png.write_png(os.path.join(args.viz_dir, f"{i:06d}.png"), rgb)
        if observer is not None:
            observer(last, state, backend)
        i += n

    steady = [s["dt"] for s in stats[chunk:]] or [first_time]
    wall = time.time() - t_loop
    fps = len(steady) / max(sum(steady), 1e-9)
    print(f"{TAG} {len(stats)} steps in {wall:.1f}s "
          f"(first chunk {first_time:.1f}s, steady-state {fps:.2f} fps)")
    if disk:
        frames.close()
        print(f"{TAG} frames decoded by {seq.decoder}; the loop waited "
              f"{frames.wait_s:.2f}s on "
              f"{'the decode-ahead ring' if frames.native_ring else 'decoding'}")

    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))

    est = np.stack(poses)
    result = {"fps_steady": fps, "frames": len(stats) + 2,
              "executor": executor_since(rolled),
              "graphs": graph_summary(),
              "decoder": seq.decoder if disk else None,
              "prefetch": (dict(ring=frames.native_ring, wait_s=frames.wait_s)
                           if disk else None)}

    est_raw = None
    if backend is not None and backend.n_nodes >= 2:
        t0 = time.time()
        backend.optimize()
        est_raw = est
        est = backend.correct(est, np.asarray(frame_ids))
        result.update(
            pg_nodes=backend.n_nodes, pg_loops=backend.n_loops,
            pg_culled=backend.n_culled, pg_seconds=round(time.time() - t0, 2),
            pg_keyframe_seconds=round(pg_seconds, 2),
        )
        print(
            f"{TAG} pose graph: {backend.n_nodes} nodes, "
            f"{backend.n_loops} loop(s), {len(backend.rejected)} candidate(s) "
            f"failed verification, {backend.n_culled} culled, "
            f"optimized in {time.time() - t0:.1f}s"
        )
        if backend.rejected and not args.quiet:
            for r in backend.rejected[:10] + [
                x for x in backend.rejected[10:]
                if x["frame"] - x["matched_frame"] > 800
            ]:
                print(f"{TAG}   rejected loop {r['frame']} <-> "
                      f"{r['matched_frame']} sim {r['similarity']:.3f} "
                      f"inliers {r['inliers']}")

    if args.save_npz:
        os.makedirs(os.path.dirname(args.save_npz) or ".", exist_ok=True)
        extra = {}
        if est_raw is not None:
            extra = dict(poses_raw=est_raw, loops=json.dumps(backend.loops))
        np.savez(args.save_npz, poses=est, frame_ids=np.asarray(frame_ids),
                 stats=json.dumps(stats), **extra)
        print(f"{TAG} wrote {args.save_npz}")

    # Metrics over the finite prefix: a diverged run (non-finite poses after
    # repeated fallback) still reports how far it got instead of crashing.
    finite = np.isfinite(est.reshape(len(est), -1)).all(axis=1)
    n_ok = int(np.argmin(finite)) if not finite.all() else len(est)
    n_frozen = sum(1 for s in stats if s.get("frozen"))
    if n_frozen:
        result["frozen_frames"] = n_frozen
        print(f"{TAG} WARNING: fail-safe froze the pose on {n_frozen} "
              f"frame(s) — those frames are NOT tracking")
    if n_ok < len(est):
        result["diverged_at_frame"] = int(frame_ids[n_ok])
        print(f"{TAG} WARNING: pose non-finite from frame {frame_ids[n_ok]}; "
              f"metrics over first {n_ok} poses")
    has_gt = seq.gt_poses is not None and len(seq.gt_poses) >= n_frames
    if has_gt and n_ok >= 3:
        gt = seq.gt_poses[frame_ids][:n_ok]
        est_m = est[:n_ok]
        ate = ate_rmse(positions_from_poses(est_m), positions_from_poses(gt))
        t_rpe, r_rpe = rpe(est_m, gt)
        result.update(ate_rmse_m=float(ate), rpe_trans_m=float(t_rpe),
                      rpe_rot_rad=float(r_rpe))
        print(f"{TAG} ATE RMSE {ate:.4f} m | RPE {t_rpe:.4f} m / {r_rpe*57.3:.3f} deg")
        if est_raw is not None:
            ate_raw = ate_rmse(
                positions_from_poses(est_raw[:n_ok]), positions_from_poses(gt)
            )
            result.update(ate_rmse_m_pre_pg=float(ate_raw))
            print(f"{TAG} ATE RMSE before pose graph: {ate_raw:.4f} m "
                  f"({ate_raw / max(ate, 1e-9):.1f}x)")

    name = args.dataset if disk else f"{args.dataset}/{args.spec}"
    if args.trajectory_pdf or args.map_pdf:
        tab = state.table
        lm = tab.landmark[tab.state == STATE_TRIANGULATED].cpu().numpy()
    if args.trajectory_pdf:
        gtp = positions_from_poses(seq.gt_poses[frame_ids]) if has_gt else None
        viz.save_trajectory_plot(args.trajectory_pdf, positions_from_poses(est), gtp, lm,
                                 title=f"{name} ({len(frame_ids)} frames)")
        print(f"{TAG} wrote {args.trajectory_pdf}")
    if args.map_pdf:
        viz.save_point_cloud_plot(args.map_pdf, lm, est, title=f"{name} map")
        print(f"{TAG} wrote {args.map_pdf}")
    if args.landmarks_pdf:
        viz.save_landmark_history_plot(
            args.landmarks_pdf,
            np.asarray([s["frame"] for s in stats]),
            np.asarray([s["tri"] for s in stats]),
            np.asarray([s["cand"] for s in stats]),
            np.asarray([s["tracked"] for s in stats]),
            title=f"{name} landmark history",
        )
        print(f"{TAG} wrote {args.landmarks_pdf}")

    return 0, Run(result=result, poses=est, poses_raw=est_raw, frame_ids=frame_ids,
                  stats=stats, state=state, backend=backend, seq=seq)


def main(argv=None) -> int:
    rc, done = run(parse_args(argv))
    if done is not None:
        print(json.dumps(done.result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
