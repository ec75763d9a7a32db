#!/usr/bin/env python
"""The SPD solvers of BA and PnP against a dense LU solve, at the
deployment shapes, on one CUDA GPU — the twin of the JAX package's
tools/bench_solvers.py.

  * BA: one Gauss-Newton step (`models/ba.py::_gn_step`) on the demo window
    at W = 6, L = 1024 (`parallel/dist_ba.py::demo_window`, seed 3), its
    6W x 6W Schur camera system solved (a) by `torch.linalg.solve` on the
    dense system (LU with partial pivoting) and (b) by the blocked Cholesky
    of `ops/linalg.py::spd_solve_blocked`, the step's own. The solver is
    passed to the step as an argument; everything else in the step is the
    same.
  * PnP: ten 6x6 SPD solves in a row, as `refine_pose_gn` makes one per GN
    iteration (each depending on the last, as in a scan): (a)
    `torch.linalg.solve` and (b) `ops/linalg.py::spd_solve_small`.

Each case: the mean over `--reps` calls on the host clock with one
synchronize at the end (the JAX tool's measure), and how far the two
solvers' results differ, max |a - b| / max |b|: for BA the step's poses and
landmarks (`ba_pose_rel_diff`, `ba_landmark_rel_diff`) and, for the record,
the camera system's solution itself (`ba_solve_rel_diff`: the 1e8 gauge
pivot leaves it ill-conditioned, so it differs by the f32 condition, some
1e-5); for PnP the ten solutions (`pnp_solve_rel_diff`). The tests hold the
step's results and the PnP solutions within 1e-4. Prints the card's name and
power limit and one JSON line.

    python tools/bench_solvers_torch.py [--reps 30]
    python tools/bench_solvers_torch.py --device cpu --reps 2   # on the CPU, only when asked
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

BA_LANDMARKS, BA_WINDOW = 1024, 6
PNP_SOLVES = 10


def _mean_ms(fn, dev, reps: int) -> float:
    """Mean ms of `reps` calls of fn after one, with one synchronize at the
    end (host clock)."""
    fn()
    bench_torch.sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    bench_torch.sync(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def _rel_diff(a, b) -> float:
    """max |a - b| / max |b|: how far two solutions of one system differ."""
    return float((a - b).abs().max() / b.abs().max())


def lu_blocked(S, b):
    """The block system S (..., W, W, B, B), b (..., W, B) solved densely by
    torch.linalg.solve (LU with partial pivoting)."""
    import torch

    w, bs = S.shape[-4], S.shape[-2]
    lead = S.shape[:-4]
    dense = S.transpose(-3, -2).reshape(lead + (w * bs, w * bs))
    return torch.linalg.solve(dense, b.reshape(lead + (w * bs,))).reshape(b.shape)


def lu_small(H, g):
    import torch

    return torch.linalg.solve(H, g[..., None])[..., 0]


def bench(dev, reps: int = 30) -> dict:
    import torch

    from vo_tpu_torch.models.ba import BAWindow, _gn_step
    from vo_tpu_torch.ops.linalg import spd_solve_blocked, spd_solve_small
    from vo_tpu_torch.parallel.dist_ba import demo_window

    K_np = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    K = torch.as_tensor(K_np, device=dev).reshape(1, 3, 3)
    win = demo_window(BA_LANDMARKS, num_keyframes=BA_WINDOW, seed=3, device=dev)
    win = BAWindow(*(f[None] for f in win))  # one lane, as ba_refine runs it
    out = {}

    # The step's own camera system, caught through the solver argument and
    # solved both ways; then the step's results with each solver.
    systems = []

    def caught(S, b):
        systems.append((S, b))
        return spd_solve_blocked(S, b)

    _gn_step(win, K, 1e-3, 2.0, solve=caught)
    (S, b), = systems
    out["ba_solve_rel_diff"] = _rel_diff(lu_blocked(S, b), spd_solve_blocked(S, b))
    steps = {}
    for name, solve in (("lu", lu_blocked), ("cholesky", spd_solve_blocked)):
        def step(solve=solve):
            return _gn_step(win, K, 1e-3, 2.0, solve=solve)

        steps[name] = step()
        out[f"ba_gn_iter_{name}_ms"] = _mean_ms(step, dev, reps)
    out["ba_pose_rel_diff"] = _rel_diff(steps["lu"][0], steps["cholesky"][0])
    out["ba_landmark_rel_diff"] = _rel_diff(steps["lu"][1], steps["cholesky"][1])
    out["ba_lu_over_cholesky"] = out["ba_gn_iter_lu_ms"] / out["ba_gn_iter_cholesky_ms"]

    rng = np.random.default_rng(0)
    J = torch.as_tensor(rng.normal(size=(64, 6)).astype(np.float32), device=dev)
    H0 = J.T @ J + 1e-2 * torch.eye(6, device=dev)
    g0 = torch.as_tensor(rng.normal(size=(6,)).astype(np.float32), device=dev)

    def chain(solver):
        def run():
            carry, ds = torch.zeros((), device=dev), []
            for _ in range(PNP_SOLVES):
                d = solver(H0 + carry * 1e-6, g0)
                carry = carry + d.sum() * 0.0 + 1.0
                ds.append(d)
            return torch.stack(ds)
        return run

    pnp = {}
    for name, solver in (("lu", lu_small), ("cholesky", lambda H, g: spd_solve_small(H, g, 6))):
        run = chain(solver)
        pnp[name] = run()
        out[f"pnp_{PNP_SOLVES}_solves_{name}_ms"] = _mean_ms(run, dev, reps)
    out["pnp_solve_rel_diff"] = _rel_diff(pnp["lu"], pnp["cholesky"])
    out["pnp_lu_over_cholesky"] = (out[f"pnp_{PNP_SOLVES}_solves_lu_ms"]
                                   / out[f"pnp_{PNP_SOLVES}_solves_cholesky_ms"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    p.add_argument("--reps", type=int, default=30)
    args = p.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "bench_solvers_torch")
    if dev is None:
        return 2
    card = bench_torch.card_name(dev)
    print(f"[card] {card}")
    print(json.dumps({"tool": "bench_solvers_torch", "device": card,
                      "ba_window": [BA_WINDOW, BA_LANDMARKS], **bench(dev, args.reps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
