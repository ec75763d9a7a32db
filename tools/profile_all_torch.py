#!/usr/bin/env python
"""Part-by-part profile of the VO step on one CUDA GPU — the twin of the JAX
package's tools/profile_all.py, profile_components.py and
profile_detect_match.py in one tool.

    python tools/profile_all_torch.py                          # the city, on cuda:0
    python tools/profile_all_torch.py --dataset kitti --data-root ./data
    python tools/profile_all_torch.py --device cpu --reps 1    # on the CPU, only when asked

Reads the first 6 frames of a `vo_tpu_torch.data.Sequence` (`--dataset
synthetic`: the city rendered once into <data-root>/synthetic; `kitti`: KITTI
05 under <data-root>/kitti/05), bootstraps on frames 0 and 2 (capacity 1024,
seed 2023) and times, on frame 3 and that state:

  * a no-op op (x + 1.0 on 8 floats) and, on the card, an empty kernel
    launch through the port's ctypes path: the floor under every row;
  * `vo_step` with BA on and off;
  * `build_pyramid`, `pyramidal_lk` over the table's 1024 points;
  * detection as the step runs it: the corner kernel (K1: response + NMS),
    then the selection (top-1024), and both together;
  * `pnp_ransac` with 256 hypotheses, `triangulate_dlt` over 1024 points,
    `ba_refine` with 5 iterations on the state's window;
  * `match_descriptors` over two random (1024, 361) descriptor sets;
  * then 40-frame rollouts (frames 3-5 ping-ponged, the JAX tool's order)
    with BA off and on: a warm-up, then a timed run with the same draws.

Each part's row: `host_ms`, the best of `--reps` calls, each ending in a
synchronize (the JAX tool's sync mode); on the card also `device_ms`, the
summed time of the CUDA kernels of one call traced by torch.profiler
(device activity only; a part under 5 ms is traced over 10 calls), and the
`kernels` it launches. Rollout rows give host time per frame and frames/s
of the timed 40-frame rollout and, on the card, its device ms a frame
(`device_ms`, the captured step's span from its start mark to its end mark
on the card's clock) and `device_idle_pct`, the card's time between steps
over the steps' wall time, both from the runner's own spans over the timed
rollout, untraced (vo_tpu_torch/models/spans.py). Under `--device cpu` the
device columns are null: a CPU run says nothing about the card.

Prints the card's name and power limit, a table, and one JSON line.
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

CAPACITY = 1024
DESC_D = 19 * 19  # the matcher's descriptor length (patch radius 9)
ROLLOUT_STEPS = 40
FRAMES = 6


def host_ms(fn, dev, reps: int) -> float:
    """Best of `reps` calls of fn, each ending in a synchronize, after one
    call to warm up (ms, host clock)."""
    fn()
    bench_torch.sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        bench_torch.sync(dev)
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def device_busy(fn, dev, calls: int = 1) -> tuple[float, float]:
    """(ms, kernels) of the CUDA kernels of one call of fn: `calls` calls
    traced by torch.profiler (device activity only: the trace of a step
    holds thousands of kernels, and host-op events would multiply its
    processing), summed and divided by `calls`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        bench_torch.sync(dev)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    return (sum(dev_us(e) for e in events) / 1e3 / calls,
            sum(e.count for e in events) / calls)


def _row(name: str, fn, dev, reps: int) -> dict:
    ms = host_ms(fn, dev, reps)
    row = {"name": name, "host_ms": ms, "device_ms": None, "kernels": None}
    if dev.type == "cuda":
        # A part that takes under 5 ms is traced over 10 calls.
        d_ms, n = device_busy(fn, dev, 10 if ms < 5.0 else 1)
        row.update(device_ms=d_ms, kernels=n)
    return row


def profile(frames, K, dev, reps: int = 3) -> list[dict]:
    """The rows over `frames` ((N >= 6, H, W) f32 on `dev`) with intrinsics K
    (3, 3)."""
    import torch

    from vo_tpu_torch.models import graphed, spans
    from vo_tpu_torch.models.ba import ba_refine
    from vo_tpu_torch.models.feature_table import STATE_TRIANGULATED
    from vo_tpu_torch.models.pipeline import bootstrap, vo_step
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.ops.descriptors import match_descriptors
    from vo_tpu_torch.ops.harris import select_from_masked
    from vo_tpu_torch.ops.image import build_pyramid
    from vo_tpu_torch.ops.klt import pyramidal_lk
    from vo_tpu_torch.ops.pnp import pnp_ransac
    from vo_tpu_torch.ops.triangulate import triangulate_dlt
    from vo_tpu_torch.utils.config import BAConfig, VOConfig

    cfg = VOConfig(capacity=CAPACITY)
    cfg_noba = cfg.replace(ba=BAConfig(enabled=False))
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    state, _ = bootstrap(frames[0], frames[2], K, cfg,
                         torch.Generator(device=dev).manual_seed(bench_torch.SEED))
    img = frames[3]
    det, klt = cfg.detector, cfg.klt
    rows = []

    def add(name, fn):
        rows.append(_row(name, fn, dev, reps))

    zeros = torch.zeros(8, device=dev)
    add("noop x + 1.0", lambda: zeros + 1.0)
    if dev.type == "cuda":
        add("empty_launch (ctypes)", lambda: kernels.empty_launch(dev))
    add("vo_step (ba on)", lambda: vo_step(state, img, K, cfg))
    add("vo_step (ba off)", lambda: vo_step(state, img, K, cfg_noba))

    add("build_pyramid", lambda: build_pyramid(img, klt.pyramid_levels))
    pyr_new = build_pyramid(img, klt.pyramid_levels)
    add(f"pyramidal_lk {CAPACITY}pts", lambda: pyramidal_lk(
        list(state.pyramid), pyr_new, state.table.xy, radius=klt.radius,
        max_iters=klt.max_iters, eps=klt.eps, max_err=klt.max_err,
        min_eig_threshold=klt.min_eig_threshold))

    def k1():
        return kernels.corner_response_nms(img, det.method, det.patch_size, det.kappa,
                                           det.nms_radius)

    masked = k1()

    def select(m):
        return select_from_masked(m, CAPACITY, border=det.border,
                                  quality_level=det.quality_level)

    add("corner_response_nms (K1)", k1)
    add(f"select_from_masked top{CAPACITY}", lambda: select(masked))
    add(f"detect (K1 + top{CAPACITY})", lambda: select(k1()))

    tri = state.table.state == STATE_TRIANGULATED
    gen = torch.Generator(device=dev).manual_seed(1)
    add(f"pnp_ransac {cfg.pnp.num_hypotheses}hyp", lambda: pnp_ransac(
        gen, state.table.landmark, state.table.xy, K, valid=tri,
        inlier_threshold_px=cfg.pnp.inlier_threshold_px,
        num_hypotheses=cfg.pnp.num_hypotheses, refine_iters=cfg.pnp.refine_iters))
    eye = torch.eye(3, 4, device=dev)
    P1 = (K @ eye).expand(CAPACITY, 3, 4)
    P2 = K @ torch.cat([torch.eye(3, device=dev), torch.ones(3, 1, device=dev)], 1)
    add(f"triangulate_dlt {CAPACITY}", lambda: triangulate_dlt(
        P1, P2, state.table.track_xy, state.table.xy))
    add(f"ba_refine {cfg.ba.iters} iters", lambda: ba_refine(state.window, K,
                                                             iters=cfg.ba.iters))
    rng = np.random.default_rng(2023)
    d1, d2 = (torch.as_tensor(rng.normal(0, 1, (CAPACITY, DESC_D)).astype(np.float32),
                              device=dev) for _ in range(2))
    add(f"match_descriptors {CAPACITY}x{DESC_D}", lambda: match_descriptors(d1, d2))

    order = ((list(range(3, FRAMES)) + [4, 3, 2, 1, 2]) * ROLLOUT_STEPS)[:ROLLOUT_STEPS]
    stack = frames[order]
    for label, c in (("ba off", cfg_noba), ("ba on", cfg)):
        runs = bench_torch.warm_and_timed(state, stack, K, c)
        row = {"name": f"rollout {ROLLOUT_STEPS}f ({label})",
               "executor": runs.executor,
               "host_ms": 1e3 * runs.seconds / ROLLOUT_STEPS,
               "fps": ROLLOUT_STEPS / runs.seconds, "device_ms": None, "kernels": None,
               "device_idle_pct": None}
        if runs.executor == "graphs":
            # The runner's spans hold the timed rollout alone: the capture's
            # and warm-up's marks are not kept, the warm-up ran eagerly.
            s = spans.statistics([graphed.runner_for(state, stack, K, c).span_readout()])
            row.update(device_ms=s["step_ms"]["mean"], device_idle_pct=s["device_idle_pct"])
        rows.append(row)
    return rows


def read_frames(dataset: str, data_root: str, dev):
    """The first 6 frames of the sequence on `dev` and its K."""
    import torch

    from vo_tpu_torch.data import Sequence

    seq = Sequence(dataset, path=data_root, render_device=str(dev))
    n = min(FRAMES, len(seq))
    frames = torch.from_numpy(np.stack([seq.get_frame(i) for i in range(n)])).to(dev)
    return frames, seq.K


def print_table(rows: list[dict]) -> None:
    def f(v, fmt):
        return "-" if v is None else format(v, fmt)

    print(f"{'part':36s} {'host ms':>10s} {'device ms':>10s} {'idle %':>7s} {'kernels':>8s}")
    for r in rows:
        fps = f"  ({r['fps']:.2f} frames/s)" if "fps" in r else ""
        print(f"{r['name']:36s} {r['host_ms']:10.3f} {f(r['device_ms'], '10.3f')} "
              f"{f(r.get('device_idle_pct'), '7.3f')} {f(r['kernels'], '8.0f')}{fps}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", choices=["kitti", "synthetic"], default="synthetic")
    p.add_argument("--data-root", default="./data")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "profile_all_torch")
    if dev is None:
        return 2
    card = bench_torch.card_name(dev)
    print(f"[card] {card}")
    frames, K = read_frames(args.dataset, args.data_root, dev)
    rows = profile(frames, K, dev, args.reps)
    print_table(rows)
    print(json.dumps({"tool": "profile_all_torch", "device": card, "dataset": args.dataset,
                      "frame": list(frames.shape[-2:]), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
