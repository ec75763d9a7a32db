"""What the port's tools share and bench_torch.py does not: the device a
tool runs on, counting kernel launches around a call, running a table of
configurations, and bootstrapping the city for a per-frame stepper.

Imported by the tools under tools/ (their own directory is on the path when
they run as scripts) and by chip_smoke.py and the tests, which put tools/ on
the path first. Imports nothing of the port at load.
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench_torch  # noqa: E402  (imports nothing of the port at load)


def cuda_or_cpu(choice: str, tool: str):
    """The device a tool runs on: cuda:0, or the CPU when `choice` is "cpu".
    None, with the reason on stderr, when cuda is asked for and no card is
    visible (the tool then exits 2)."""
    import torch

    if choice == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: no CUDA device visible (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return None
    return torch.device("cuda:0" if choice == "cuda" else "cpu")


def counting_launches(fn, *a, **k):
    """(fn(*a, **k), the kernel launches it made by name): the counts are
    read before and after, never reset, so an enclosing count goes on."""
    from vo_tpu_torch.ops import kernels

    before = dict(kernels.launch_counts)
    out = fn(*a, **k)
    return out, {n: kernels.launch_counts[n] - before[n] for n in before}


def run_variants(variants: dict, measure) -> list:
    """`measure(name, cfg)` for each variant in order -> its row, a dict
    that starts with "variant". A variant that raises gets its traceback on
    stderr and a row {"variant", "error"}; the others still run, and the
    tool exits 1 at the end when any row has an "error"."""
    rows = []
    for name, cfg in variants.items():
        try:
            rows.append({"variant": name, **measure(name, cfg)})
        except Exception as exc:  # reported, and the tool's exit code says so
            traceback.print_exc()
            print(f"{name}: FAILED: {type(exc).__name__}: {exc}", flush=True)
            rows.append({"variant": name, "error": f"{type(exc).__name__}: {exc}"})
    return rows


def city_stepper(data_root: str, dev, cfg):
    """For the per-frame steppers: (the city's Sequence, K on the device,
    frame(i) -> frame i on the device, the state bootstrapped on frames 0
    and 2 with the seeded sampler)."""
    import torch

    from vo_tpu_torch.data import Sequence
    from vo_tpu_torch.models.pipeline import bootstrap

    seq = Sequence("synthetic", path=data_root, render_device=str(dev))
    K = torch.as_tensor(seq.K, device=dev)

    def frame(i):
        return torch.as_tensor(seq.get_frame(i), device=dev)

    state, _ = bootstrap(frame(0), frame(2), K, cfg, bench_torch.seeded(dev))
    return seq, K, frame, state
