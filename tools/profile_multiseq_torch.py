#!/usr/bin/env python
"""Trace a few lockstep steps of the multi-sequence run with torch.profiler
and report how busy the GPU is — needs one CUDA GPU.

    python tools/profile_multiseq_torch.py [--lanes 6] [--steps 20] [--frames 52]

Renders `--lanes` of the multi-sequence cities (640x480) on the device,
bootstraps and stacks them, warms up a few steps, times `--steps` batched
steps with the host clock and no profiler, then runs the next `--steps`
steps under the profiler (CPU + CUDA activities). Prints one JSON object:
the step time without and with the profiler (tracing slows the host), the
summed device time of all kernels (device-side events only), the busy and
idle share of the device — kernel time over the UNPROFILED step time, the
honest denominator, and over the profiled wall time beside it — the number
of kernels launched per step, and the ten kernels with the most device
time. `--trace PATH` also writes the Chrome trace there (tens of MB
for 20 steps).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lanes", type=int, default=6)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--frames", type=int, default=52)
    p.add_argument("--capacity", type=int, default=512)
    p.add_argument("--trace", default="", help="write the Chrome trace to this path")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_multiseq_torch: no CUDA device visible", file=sys.stderr)
        return 2
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models.pipeline import bootstrap
    from vo_tpu_torch.parallel.multiseq import batched_vo_step, stack_states
    from vo_tpu_torch.utils.config import VOConfig

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = VOConfig(capacity=args.capacity)
    seqs = synthetic.multiseq_sequences(dev, args.frames, str(args.lanes))
    names = list(seqs)
    states = stack_states([
        bootstrap(seqs[n].frames[0], seqs[n].frames[2], seqs[n].K, cfg,
                  torch.Generator(device=dev).manual_seed(2023 + i))[0]
        for i, n in enumerate(names)])
    states = states._replace(kf_adaptive=torch.tensor(
        [n in synthetic.ADAPTIVE_LANES for n in names], device=dev))
    Ks = torch.stack([seqs[n].K for n in names])
    images = torch.stack([seqs[n].frames[3:] for n in names], dim=1)
    warm = 6
    if images.shape[0] < warm + 2 * args.steps:
        p.error(f"--frames must be at least {3 + warm + 2 * args.steps}")

    def run(lo, hi):
        nonlocal states
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(lo, hi):
            states, _ = batched_vo_step(states, images[i], Ks, cfg)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    run(0, warm)
    plain_ms = run(warm, warm + args.steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = run(warm + args.steps, warm + 2 * args.steps)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # Device-side events only: a host op's entry repeats its kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3
    launches = sum(e.count for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:10]
    out = {
        "card": card,
        "lanes": len(names), "steps": args.steps,
        "executor": "eager",  # batched_vo_step, traced step by step
        "step_ms": plain_ms / args.steps,
        "profiled_step_ms": wall_ms / args.steps,
        "device_ms_per_step": device_ms / args.steps,
        "device_busy_share": device_ms / plain_ms,
        "device_idle_share": 1.0 - device_ms / plain_ms,
        "device_busy_share_of_profiled_wall": device_ms / wall_ms,
        "kernels_per_step": launches / args.steps,
        "top_kernels": [
            {"name": e.key[:80], "count": e.count, "device_ms": dev_us(e) / 1e3} for e in top],
    }
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
