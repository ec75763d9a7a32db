"""The benchmark of vo_tpu_torch: one process runs one cell once.

    python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes its inputs (the cell's city, rendered on the card), sets up and
warms up (bootstrap, capture of the step's graph, a few replayed frames),
measures for `--seconds`, judges what the window produced against the
plain reference, and prints one JSON line last. With `--trace 0` the line
carries the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from a traced slice of the window. See vobench/README.md.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up runs from here to the first timed frame

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, NamedTuple  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout, so only a
# cell's first run there builds (the port's own kernels build into
# vo_tpu_torch/build/).
CACHE = CHECKOUT / ".vobench_cache"
FRAMES = CACHE / "frames"  # the rendered frames of each configuration, written once
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

# Top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vo_tpu"})


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: `vo_tpu_torch` is not `vo_tpu`."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class Reading(NamedTuple):
    """What a per-layer reader (vobench/metrics/<name>.py) reads from."""

    slice: Any  # trace.Slice, or None
    lanes: int
    height: int
    width: int
    capacity: int
    levels: int
    summary: dict | None  # graphed.summary() of the run


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() else "no card listed"


def pooled_ate(setup, boot, answers) -> float | None:
    """ATE RMSE over every pose of every whole pass and lane, each pass
    Sim(3)-aligned to the ground truth on its own; None without one."""
    import numpy as np

    from vobench import check

    sq = []
    for p in answers:
        if not p.complete:
            continue
        for lane in range(setup.n_lanes):
            est, idx = check.trajectory(boot.poses[lane], p, lane, setup.boot_frames)
            sq.append(check.ate_sq_errors(est, setup.gt[lane][idx]))
    return float(np.sqrt(np.concatenate(sq).mean())) if sq else None


def end_to_end(cell, lane_frames: int, seconds: float, values: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics (those BENCHMARK.json gives it), from
    the window's counts and clock and the comparison's numbers."""
    got = {"setup_s": setup_s, "fps": lane_frames / seconds,
           "rpe_mm": 1e3 * values["seg_err_med_m"]}
    return {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in got}


def run(cell, seed: int, seconds: float, traced: bool, device: str,
        log=print, frame_cache: bool = True) -> dict:
    """Run `cell` once on `device` and return the result line's object
    (the look for a card is the caller's)."""
    import numpy as np
    import torch

    from vobench import check, harness, registry, trace
    from vo_tpu_torch.models import graphed
    from vo_tpu_torch.utils.cache import RUNNERS

    dev = torch.device(device)
    t_start = time.perf_counter()
    setup = harness.make_setup(cell.config, dev, FRAMES if frame_cache else None,
                               cell.traffic.get("copies", 1))
    t_frames = time.perf_counter()
    boot = harness.bootstrap(setup, seed)
    t_boot = time.perf_counter()
    capture_s = harness.warm_up(setup, boot, cell.traffic)
    setup_s = time.perf_counter() - _T0
    log(f"[vobench] set-up {setup_s:.3f} s: imports {t_start - _T0:.3f}, frames "
        f"{t_frames - t_start:.3f}, bootstrap {t_boot - t_frames:.3f}, capture and warm-up "
        f"{time.perf_counter() - t_boot:.3f} (capture {capture_s:.3f})")
    win = harness.window(setup, boot, seed, seconds, cell.traffic, traced=traced)
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    summary = graphed.summary()
    answers = check.collect(win, setup.n_lanes)
    sliced = win.slice() if win.slice is not None else None
    poses = np.concatenate([p.pose.reshape(-1, 16) for p in answers]) if answers else None
    oks = np.concatenate([p.pose_ok.reshape(-1) for p in answers]) if answers else None
    attempted = 0 if oks is None else int(oks.size)
    failed = 0 if oks is None else int((~oks.astype(bool) | ~np.isfinite(poses).all(-1)).sum())
    log(f"[vobench] {cell.name} seed {seed}: {win.lane_frames} lane-frames in "
        f"{win.seconds:.3f} s over {len(win.passes)} passes "
        f"({sum(p.complete for p in win.passes)} whole), memory peak {peak} B, executor "
        f"summary {summary}")

    # The program's state is freed before the reference runs.
    lane_frames, seconds_run = win.lane_frames, win.seconds
    del win
    RUNNERS.clear()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = check.numbers(setup, answers)
    correct, checks = check.judge(values, cell.limits)
    e2e = end_to_end(cell, lane_frames, seconds_run, values, setup_s)
    log("[vobench] not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in values.items() if k not in checks)
        + f"; ATE over the window's whole passes {pooled_ate(setup, boot, answers)!r} m; "
        f"the comparison took {time.perf_counter() - t_check:.3f} s")

    result: dict = {"correct": correct, "attempted": attempted, "failed": failed}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        spec = setup.lanes[0].spec
        ctx = Reading(sliced, setup.n_lanes, spec.height, spec.width, setup.cfg.capacity,
                      setup.cfg.klt.pyramid_levels, summary)
        metrics = {}
        for m in cell.per_layer:
            v = registry.metric(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
        if sliced is not None:
            device_info.update(busy_s=trace.busy_s(sliced), window_s=trace.span_s(sliced))
            result["breakdown"] = {"device_ops": trace.top_device_ops(sliced),
                                   "idle_gaps": trace.idle_gaps(sliced)}
            log(f"[vobench] traced slice: {sliced.steps} steps, {len(sliced.device)} device "
                f"operations, busy {device_info['busy_s']:.6f} s of "
                f"{device_info['window_s']:.6f} s; end to end (not reported): {e2e}")
    else:
        result["metrics"] = e2e
        log(f"[vobench] end to end: {e2e}")
    result["device"] = device_info
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from vobench import registry

    cell = registry.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"vobench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    print(f"[vobench] card: {card_line()}", file=sys.stderr)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                 log=lambda s: print(s, file=sys.stderr))
    leaked = forbidden_modules(list(sys.modules))
    if leaked:
        print(f"vobench: the run loaded {leaked}: no module of JAX or of the JAX package "
              "may load", file=sys.stderr)
        return 3
    print(f"[vobench] correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
