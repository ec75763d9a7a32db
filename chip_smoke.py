#!/usr/bin/env python3
"""Smoke test of vo_tpu_torch on one CUDA GPU — the quickest proof that the
port builds, agrees with its plain PyTorch versions, and runs its main path.

    python3 chip_smoke.py            # full headline run (600 frames)
    python3 chip_smoke.py --frames 60  # shorter rehearsal of the same phases

Phases:
  1. identify the card (nvidia-smi name and power limit);
  2. build the CUDA kernels from vo_tpu_torch/csrc (nvcc, sm_90a);
  3. K1 corner_response_nms: kernel vs plain version on the card, both modes,
     several shapes and a batch of 3; both timed at 480x640;
  4. K2 extract_patches: kernel vs plain, bit-identical, sizes 21/35, K=1024
     on a 516x676 level (corners needing clamping included), a batch of 3;
     both timed;
  5. the headline run: render the synthetic city on the device, check two
     frames against the reference numpy renderer, run bootstrap + vo_step
     over the sequence with VOConfig(capacity=1024), and gate the launch
     counts, finiteness, pose_ok count and ATE against exact ground truth.

Prints the card line, a JSON line describing every kernel, and as the last
line {"ok": true, "device": {...}}. Any failed phase exits non-zero without
that line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REFERENCE_ATE_M = 1.181  # tools/headline_expected.json (the JAX package)
ATE_GATE_M = 1.77  # 1.5x the reference, just above its 1.753 m regression
POSE_OK_SLACK = 7  # pose_ok must hold on all but this many frames

K1_SHAPES = [(150, 260), (64, 200), (30, 40), (480, 640)]
K1_MODES = [("shi_tomasi", 7, 8), ("harris", 9, 5)]


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn() in ms over `reps` launches (CUDA events,
    after a warm-up)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _interleaved(plain, kernel) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain) -> (kernel_ms, plain_ms)."""
    p1 = _time_ms(plain)
    k1 = _time_ms(kernel)
    k2 = _time_ms(kernel)
    p2 = _time_ms(plain)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def phase_k1(dev, record: dict) -> None:
    import torch
    from vo_tpu_torch.ops import kernels

    rng = np.random.default_rng(2023)
    worst = 0.0
    cases = [(shape, m) for shape in K1_SHAPES for m in K1_MODES]
    cases.append(((3, 96, 200), K1_MODES[0]))
    for shape, (mode, patch, r) in cases:
        img = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32), device=dev)
        got = kernels.corner_response_nms(img, mode, patch, 0.08, r, use_kernel=True)
        want = kernels.corner_response_nms_plain(img, mode, patch, 0.08, r)
        torch.cuda.synchronize()
        fg, fw = torch.isfinite(got), torch.isfinite(want)
        if not torch.equal(fg, fw):
            raise AssertionError(
                f"K1 {mode} {shape}: finite masks differ at {int((fg != fw).sum())} px")
        if bool(fw.any()):
            diff = (got[fw] - want[fw]).abs()
            err = float(diff.max())
            if not bool((diff <= 1e-2 + 1e-5 * want[fw].abs()).all()):
                raise AssertionError(f"K1 {mode} {shape}: max abs err {err}")
            worst = max(worst, err)
        print(f"[k1] {mode:10s} shape={shape} maxima={int(fw.sum())} "
              f"max_abs_err={float(diff.max()) if bool(fw.any()) else 0.0:.3g} ok")
    img = torch.as_tensor(rng.uniform(0, 255, (480, 640)).astype(np.float32), device=dev)
    ms, plain_ms = _interleaved(
        lambda: kernels.corner_response_nms_plain(img, "shi_tomasi", 7, 0.08, 8),
        lambda: kernels.corner_response_nms(img, "shi_tomasi", 7, 0.08, 8, use_kernel=True),
    )
    print(f"[k1] 480x640 shi_tomasi p7 r8: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    record.update(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def phase_k2(dev, record: dict) -> None:
    import torch
    from vo_tpu_torch.ops import kernels

    rng = np.random.default_rng(7)
    h, w, k = 516, 676, 1024
    img = torch.as_tensor(rng.uniform(0, 255, (h, w)).astype(np.float32), device=dev)
    times = {}
    for size in (21, 35):
        # Corners across the level and beyond its edges (clamped starts).
        cor_np = np.stack([rng.integers(-40, w + 40, k), rng.integers(-40, h + 40, k)], -1)
        cor = torch.as_tensor(cor_np.astype(np.int32), device=dev)
        got = kernels.extract_patches(img, cor, size, use_kernel=True)
        want = kernels.extract_patches_plain(img, cor, size)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 size {size}: not bit-identical")
        times[size] = _interleaved(
            lambda: kernels.extract_patches_plain(img, cor, size),
            lambda: kernels.extract_patches(img, cor, size, use_kernel=True),
        )
        print(f"[k2] K={k} size={size} on {h}x{w}: bit-identical; kernel "
              f"{times[size][0]:.4f} ms, plain {times[size][1]:.4f} ms")
    imgs = torch.as_tensor(rng.uniform(0, 255, (3, 104, 384)).astype(np.float32), device=dev)
    cor = torch.as_tensor(rng.integers(-20, 400, (3, 70, 2)).astype(np.int32), device=dev)
    got = kernels.extract_patches(imgs, cor, 17, use_kernel=True)
    if not torch.equal(got, kernels.extract_patches_plain(imgs, cor, 17)):
        raise AssertionError("K2 batch of 3: not bit-identical")
    print("[k2] B=3 K=70 size=17: bit-identical")
    record.update(max_abs_err=0.0, ms=times[35][0], plain_ms=times[35][1])


def phase_headline(dev, n_frames: int, records: dict) -> None:
    import torch
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses, rpe
    from vo_tpu_torch.models.pipeline import bootstrap, vo_step
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.utils.config import VOConfig

    cfg = VOConfig(capacity=1024)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    seq = synthetic.headline_sequence(dev, n_frames)
    spec = seq.spec
    torch.cuda.synchronize()
    print(f"[headline] rendered {tuple(seq.frames.shape)} on the device in "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(2023)
    t0 = time.perf_counter()
    state, out0 = bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg, gen)
    torch.cuda.synchronize()
    t_boot = time.perf_counter() - t0
    outs = []
    t0 = time.perf_counter()
    for i in range(3, n_frames):
        state, out = vo_step(state, seq.frames[i], seq.K, cfg)
        outs.append(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    steps = len(outs)

    poses = np.concatenate([
        np.stack([np.eye(4, dtype=np.float32), out0.pose.cpu().numpy()]),
        torch.stack([o.pose for o in outs]).cpu().numpy(),
    ])
    pose_ok = int(torch.stack([o.pose_ok for o in outs]).sum())
    frozen = int(torch.stack([o.frozen for o in outs]).sum())
    finite = int(np.isfinite(poses[2:]).all(axis=(1, 2)).sum())
    gt = seq.gt_poses[[0, 2] + list(range(3, n_frames))]
    ate = ate_rmse(positions_from_poses(poses), positions_from_poses(gt))
    t_rpe, r_rpe = rpe(poses, gt)
    fps = steps / dt
    print(f"[headline] bootstrap {t_boot:.2f} s (pose_ok={bool(out0.pose_ok)}, "
          f"{int(out0.num_triangulated)} landmarks)")
    print(f"[headline] {steps} vo_steps in {dt:.2f} s = {fps:.2f} frames/s")
    print(f"[headline] ATE {ate:.4f} m (reference {REFERENCE_ATE_M} m, drift "
          f"{100.0 * (ate - REFERENCE_ATE_M) / REFERENCE_ATE_M:+.1f}%), "
          f"RPE {t_rpe:.5f} m / {np.degrees(r_rpe):.5f} deg")
    print(f"[headline] pose_ok {pose_ok}/{steps}, finite {finite}/{steps}, frozen {frozen}")
    print(f"[headline] launches: {json.dumps(counts)}")
    records["corner_response_nms"]["launches"] = counts["corner_response_nms"]
    records["extract_patches"]["launches"] = counts["extract_patches"]

    # The renderer against the reference numpy renderer on two frames.
    rects, tex = synthetic.scene(spec)
    for i in (0, n_frames // 2):
        ref = synthetic.render_frame(rects, tex, seq.gt_poses[i], spec.K(),
                                     spec.width, spec.height, dist=spec.dist)
        d = np.abs(seq.frames[i].cpu().numpy() - ref.astype(np.float32)).max()
        print(f"[headline] frame {i}: device render vs numpy max diff {d:.0f} grey levels")
        if d > 2:
            raise AssertionError(f"renderer disagrees with the reference at frame {i}: {d}")

    fails = []
    if counts["corner_response_nms"] != steps + 1:
        fails.append(f"K1 launched {counts['corner_response_nms']} times, want {steps + 1}")
    want_k2 = 2 * cfg.klt.pyramid_levels * (steps + 1)
    if counts["extract_patches"] != want_k2:
        fails.append(f"K2 launched {counts['extract_patches']} times, want {want_k2}")
    if finite != steps or frozen:
        fails.append(f"{steps - finite} non-finite poses, {frozen} frozen frames")
    if pose_ok < steps - POSE_OK_SLACK:
        fails.append(f"pose_ok on {pose_ok}/{steps} frames, want >= {steps - POSE_OK_SLACK}")
    if not ate <= ATE_GATE_M:
        fails.append(f"ATE {ate:.4f} m above the {ATE_GATE_M} m gate")
    if fails:
        raise AssertionError("; ".join(fails))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=600,
                        help="length of the headline sequence (default 600)")
    args = parser.parse_args(argv)
    if args.frames < 4:
        parser.error("--frames must be at least 4")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to test", file=sys.stderr)
        return 2
    try:
        import vo_tpu_torch
        from vo_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2
    # The kernels must come from this checkout's sources, not from a copy of
    # the package installed elsewhere.
    here = Path(__file__).resolve().parent
    if Path(vo_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: vo_tpu_torch was imported from {vo_tpu_torch.__file__}, "
              f"not from {here}", file=sys.stderr)
        return 2

    dev = torch.device("cuda:0")
    card = _card_line()
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    records = {
        "corner_response_nms": dict(
            name="corner_response_nms", route="cuda",
            source="vo_tpu_torch/csrc/corner_nms.cu",
            replaces="vo_tpu/ops/pallas_kernels.py:196"),
        "extract_patches": dict(
            name="extract_patches", route="cuda",
            source="vo_tpu_torch/csrc/patch_gather.cu",
            replaces="vo_tpu/ops/pallas_kernels.py:387"),
    }
    failed = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            fn(*a)
            print(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
        except Exception:  # a failed phase is reported; the others still run
            failed.append(name)
            print(f"[{name}] FAILED", flush=True)
            traceback.print_exc(file=sys.stdout)

    def build():
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        print(f"[build] {lib} ready in {time.perf_counter() - t0:.1f} s")
        log = lib.parent / "build.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    print(f"[build] {line.strip()}")

    run("build", build)
    if "build" not in failed:
        run("k1", phase_k1, dev, records["corner_response_nms"])
        run("k2", phase_k2, dev, records["extract_patches"])
    run("headline", phase_headline, dev, args.frames, records)

    print(f"[card] {card}")
    print(json.dumps({"kernels": list(records.values())}))
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
