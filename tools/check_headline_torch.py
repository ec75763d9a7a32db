#!/usr/bin/env python
"""The port's headline-drift gate — the twin of the JAX package's
tools/check_headline.py.

It runs the headline measurement exactly as bench_torch.py takes it
(`bench_torch.bench_synthetic_full`: the 600-frame city under
<data-root>/synthetic, capacity 1024, seed 2023, a warm-up and a timed
rollout of 597 steps) and exits 1 if the ATE differs from the port's own
expected figure, tools/headline_expected_torch.json, by more than `tol_pct`.
That file is the port's alone: the JAX package's headline_expected.json is
neither read nor written here.

    python tools/check_headline_torch.py               # run + gate, on cuda:0
    python tools/check_headline_torch.py --update      # re-baseline after an
                                                       # INTENTIONAL accuracy change
    python tools/check_headline_torch.py --device cpu  # on the CPU, only when asked

Run it before every commit that touches vo_tpu_torch/ops, models, geom or
utils/config.py. The headline ATE is bit-stable for one card and commit
(one seeded generator, no clock in the arithmetic), so the 5% tolerance
is not for run-to-run noise. The expected figure holds for the card's
route only: there LK's solve is the CUDA kernel, on the CPU its plain
version, and the two part by a few ulps a level, which over 597 steps
moves the seeded draw (at seed 2023 the card read 0.5671 m with the plain
solve and 1.359 m with the kernel, on an NVIDIA H100 80GB HBM3 at 700 W).
A CPU run is not held to the card's figure: read its ATE, not its exit
code. chip_smoke.py applies `gate` to its own headline run.

Ends in one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)

EXPECTED_PATH = Path(__file__).resolve().parent / "headline_expected_torch.json"
DEFAULT_TOL_PCT = 5.0


def gate(result: dict, expected: dict, tol_pct: float) -> tuple[bool, float]:
    """(whether the measured ATE is within `tol_pct` percent of the
    expected one, the drift in percent)."""
    drift_pct = abs(result["ate_rmse_m"] - expected["ate_rmse_m"]) / expected["ate_rmse_m"] * 100.0
    return drift_pct <= tol_pct, drift_pct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--update", action="store_true", help="re-baseline the expected ATE")
    ap.add_argument("--tol-pct", type=float, default=None, help="override tolerance (%%)")
    ap.add_argument("--data-root", default="./data",
                    help="where the city is rendered once and read from")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    args = ap.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "check_headline_torch")
    if dev is None:
        return 2
    synth = bench_torch.bench_synthetic_full(dev, args.data_root).result
    ate = synth["ate_rmse_m"]
    card = bench_torch.card_name(dev)
    line = {"tool": "check_headline_torch", "device": card, "ate_rmse_m": ate,
            "rpe_trans_m": synth["rpe_trans_m"], "frames": synth["frames"]}

    if args.update or not EXPECTED_PATH.exists():
        rec = {"ate_rmse_m": ate, "tol_pct": DEFAULT_TOL_PCT, "frames": synth["frames"],
               "device": card}
        EXPECTED_PATH.write_text(json.dumps(rec, indent=2) + "\n")
        print(f"baselined: ATE {ate} m -> {EXPECTED_PATH}")
        print(json.dumps({**line, "baselined": True}))
        return 0

    exp = json.loads(EXPECTED_PATH.read_text())
    tol = args.tol_pct if args.tol_pct is not None else exp.get("tol_pct", DEFAULT_TOL_PCT)
    ok, drift_pct = gate(synth, exp, tol)
    status = "OK" if ok else "FAIL"
    print(
        f"{status}: measured ATE {ate} m vs expected {exp['ate_rmse_m']} m "
        f"({drift_pct:.1f}% drift, tol {tol}%)  "
        f"[rpe_trans {synth['rpe_trans_m']} m, {synth['frames']} frames]"
    )
    print(json.dumps({**line, "ok": ok, "expected_ate_m": exp["ate_rmse_m"],
                      "expected_device": exp.get("device"), "drift_pct": drift_pct,
                      "tol_pct": tol}))
    if not ok:
        print(
            "Headline regressed. Either fix the regression, or — if the "
            "accuracy change is intentional and measured — rerun with "
            "--update AND update PERF.md/README in the same commit.",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
