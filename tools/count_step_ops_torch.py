#!/usr/bin/env python
"""Count the PyTorch ops one `vo_step` dispatches, single-sequence against a
lockstep batch — the host-side cost of the port's eager step.

    python tools/count_step_ops_torch.py [--lanes 6] [--steps 6]
    python tools/count_step_ops_torch.py --device cuda [--tree DIR]

Runs on the CPU by default, at a small frame size (the op count does not
depend on the frame size, only on the config, on which host branches a step
takes, and on whether the kernels or their plain versions run: on the CPU the
plain versions' ops are counted, with `--device cuda` the kernel path's, where
a kernel launch dispatches nothing but its output's allocation). `--tree`
counts another checkout of the port. Prints one JSON line per step: the
frame index, whether any lane pushed a keyframe (the BA branch) and the
number of ops dispatched, for a single sequence and for a batch of `--lanes`
lanes; then their means. An op count is not a time: it says how much eager
dispatch a step costs the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lanes", type=int, default=6)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--device", default="cpu", help="cpu (default) or cuda")
    p.add_argument("--tree", default=None,
                   help="directory that holds the vo_tpu_torch package to count "
                        "(default: the tree this script is in)")
    args = p.parse_args(argv)

    tree = Path(args.tree).resolve() if args.tree else Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(tree))
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models.pipeline import bootstrap, vo_step
    from vo_tpu_torch.parallel.multiseq import batched_vo_step, stack_states
    from vo_tpu_torch.utils.config import VOConfig

    torch.set_num_threads(2)
    dev = torch.device(args.device)
    cfg = VOConfig(capacity=args.capacity)
    small = dict(width=160, height=120, focal=104.0)
    specs = synthetic.multiseq_specs(3 + args.steps)
    seqs = [synthetic.render_sequence(dataclasses.replace(s, **small), dev)
            for s in list(specs.values())[: args.lanes]]
    states = []
    for i, seq in enumerate(seqs):
        st, _ = bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                          torch.Generator(device=dev).manual_seed(2023 + i))
        states.append(st)
    single = states[0]
    batched = stack_states(states)
    Ks = torch.stack([s.K for s in seqs])
    rows = []
    for i in range(3, 3 + args.steps):
        with _Count() as c1:
            prev_kf = int(single.last_kf_idx)
            single, _ = vo_step(single, seqs[0].frames[i], seqs[0].K, cfg)
        with _Count() as cb:
            prev_kfs = batched.last_kf_idx.clone()
            batched, _ = batched_vo_step(
                batched, torch.stack([s.frames[i] for s in seqs]), Ks, cfg)
        rows.append({
            "frame": i,
            "single_ops": c1.n, "single_ba": int(single.last_kf_idx) != prev_kf,
            "batched_ops": cb.n,
            "batched_ba": bool((batched.last_kf_idx != prev_kfs).any()),
        })
        print(json.dumps(rows[-1]))
    n = len(rows)
    print(json.dumps({
        "lanes": args.lanes, "device": args.device,
        "mean_single_ops": sum(r["single_ops"] for r in rows) / n,
        "mean_batched_ops": sum(r["batched_ops"] for r in rows) / n,
        "batched_ops_per_lane": sum(r["batched_ops"] for r in rows) / n / args.lanes,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
