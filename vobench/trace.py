"""The traced slice: a fixed run of frames inside the window under
torch.profiler (host and device activity), reduced to what the per-layer
readers and the `breakdown` need.

A frame's graph holds some 16,400 kernels, so the trace covers a few
chunks, not the window. The device is drained before the profiler starts
and before it stops, so every operation of the slice's frames, and no
other, is in the trace; it is read after the window has closed.

Device time is the UNION of the intervals of every device operation
(kernels, copies, sets) on every stream: PnP and the recovery run on
streams of their own, and summing their kernels would count overlapped
work twice.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Slice(NamedTuple):
    device: list  # (name, category, start_us, end_us) of every device operation
    host: list  # (name, start_us, end_us) of host events
    steps: int  # step calls in the slice (a step moves every lane one frame)
    lanes: int


def events(trace: dict) -> tuple[list, list]:
    """(device, host) events of a Chrome trace that torch.profiler exported."""
    device, host = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        start = float(e["ts"])
        end = start + float(e["dur"])
        if cat in DEVICE_CATS:
            device.append((e.get("name", "?"), cat, start, end))
        elif cat in HOST_CATS:
            host.append((e.get("name", "?"), start, end))
    device.sort(key=lambda d: d[2])
    host.sort(key=lambda h: h[1])
    return device, host


def profile(run, steps: int, lanes: int):
    """`run()` (which enqueues `steps` steps) under torch.profiler, the
    device drained before and after. Returns a function that reads the
    trace back into a Slice (and deletes it), for after the window."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def read() -> Slice:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="vobench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        device, host = events(trace)
        return Slice(device, host, steps, lanes)

    return read


def busy(device: list) -> list[tuple[float, float]]:
    """The union of the device operations' intervals, merged, in order."""
    merged: list[list[float]] = []
    for _, _, start, end in sorted(device, key=lambda d: d[2]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_s(s: Slice) -> float:
    return sum(b - a for a, b in busy(s.device)) * 1e-6


def span_s(s: Slice) -> float:
    """The slice's wall time on the device: first operation to last."""
    if not s.device:
        return 0.0
    return (max(d[3] for d in s.device) - s.device[0][2]) * 1e-6


def kernel_seconds(s: Slice, symbol: str) -> tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds `symbol`."""
    hits = [d for d in s.device if d[1] == "kernel" and symbol in d[0]]
    return len(hits), sum(d[3] - d[2] for d in hits) * 1e-6


def top_device_ops(s: Slice, n: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    total: dict = {}
    for name, _, start, end in s.device:
        total[name] = total.get(name, 0.0) + (end - start) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(s: Slice, n: int = 10) -> list:
    """[host event, seconds] of the longest gaps between device operations,
    each named by the innermost host event that spans the gap's middle."""
    spans = busy(s.device)
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(spans, spans[1:]) if b1[0] > b0[1]),
                  key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [h for h in s.host if h[1] <= mid <= h[2]]
        name = min(inside, key=lambda h: h[2] - h[1])[0] if inside else "no host event"
        out.append([name, (b - a) * 1e-6])
    return out
