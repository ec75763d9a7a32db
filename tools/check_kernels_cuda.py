#!/usr/bin/env python
"""On-card parity check of the port's hand-written CUDA kernels — the
counterpart of the JAX package's tools/check_pallas_tpu.py.

Builds the kernels from vo_tpu_torch/csrc (nvcc, sm_90a) and runs
chip_smoke.py's kernel checks and nothing else: `phase_k1` (the corner
kernel K1 against its plain version at every (mode, patch, r) instance and
shapes below, across and at a tile), `phase_k2` (the patch gather K2 and the
pair launch of an LK level, bit-identical), `phase_k1b` and `phase_k2b` (the
same kernels over 6 lanes), `phase_lk` and `phase_lkb` (the LK solve on each
level's patches against its plain version, one lane and six, each level
timed), `phase_ba` (BA's camera-system solve against the blocked Cholesky
and float64, one lane and six, timed). The checks are chip_smoke.py's own functions, not copies;
chip_smoke.py runs them itself, so it does not run this tool.

Exit code 0 and "PASS" when every check holds, 1 on a mismatch, 2 when no
CUDA device is visible (callers treat 2 as skip):

    python tools/check_kernels_cuda.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_kernels_cuda: no CUDA device visible; nothing to check", file=sys.stderr)
        return 2
    import chip_smoke
    from vo_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    card = chip_smoke._card_line()
    t0 = time.perf_counter()
    print(f"[build] {_build.build()} in {time.perf_counter() - t0:.1f} s")
    failures = []
    for name, phase in (("k1", chip_smoke.phase_k1), ("k2", chip_smoke.phase_k2),
                        ("k1b", chip_smoke.phase_k1b), ("k2b", chip_smoke.phase_k2b),
                        ("lk", chip_smoke.phase_lk), ("lkb", chip_smoke.phase_lkb),
                        ("ba", chip_smoke.phase_ba)):
        try:
            phase(dev, {})
        except AssertionError as exc:  # a mismatch; a build or launch error propagates
            failures.append(f"{name}: {exc}")
    if failures:
        print("FAIL:", *failures, sep="\n  ")
    else:
        print(f"PASS: K1, K2, K1b, K2b, the LK solve and BA's solve match their plain "
              f"versions on {card}")
    print(json.dumps({"tool": "check_kernels_cuda", "device": card, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
