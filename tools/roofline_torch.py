#!/usr/bin/env python
"""Speed-of-light (roofline) report for the VO hot path on one CUDA GPU — the
twin of the JAX package's tools/roofline.py.

For every hot part of the step this tool

  1. counts the bytes it must move (inputs read and outputs written, plus
     the known round trips) and the floating-point operations it does, from
     the deployment shapes: the static models of tools/roofline.py, formulas
     inline;
  2. measures its time on the card: CUDA events around `--reps` eager calls
     (`events`: host enqueue included, what the step pays), and, where the
     calls can be captured, the same calls replayed from a CUDA graph
     (`graph`: the device alone). Calls that sync the host (torch.linalg's
     error checks, data-dependent shapes) cannot be captured and keep
     `events`; each row says which time its share is taken from;
  3. sets it against the H100 SXM's peaks (NVIDIA's data sheet): HBM
     3.35 TB/s and float32 67 TFLOP/s outside the tensor cores. TF32 is off
     in the port (vo_tpu_torch/__init__.py), so the f32 rate is the bound of
     every row; the BF16 (989 TFLOP/s) and TF32 (495 TFLOP/s) tensor-core
     peaks are printed for reference only. The bound is
     max(bytes / HBM, flops / f32 peak), the share bound / time.

Shapes come from `VOConfig()`'s defaults where roofline.py's constants
differ: LK runs the configuration's 4 pyramid levels (roofline.py has
LK_LEVELS = 3), radius 8 and 10 iterations; capacity 1024, PnP 256
hypotheses and 10 GN iterations, a BA window of 6 and the 19x19 descriptor
(radius 9) are the configuration's and roofline.py's alike. The frame is the
city's 640x480 with focal 415.

Two rows more than roofline.py: the corner kernel (K1) and the patch pair
of LK level 0 (K2), with the byte/operation models of chip_smoke.py (PERF.md
section 6), so that the component bound and the kernel bound stand in one
table.

    python tools/roofline_torch.py [--reps 30] [--json out.json]
    python tools/roofline_torch.py --device cpu --reps 1   # runs the rows; no device time

Under `--device cpu` the rows run and their models print, but the time and
share columns are null: a CPU run gives no device time.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (imports nothing of the port at load)
import common_torch  # noqa: E402  (the tools' shared plumbing)
import chip_smoke  # noqa: E402  (the timing helpers and the kernels' models)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores (TF32 is off)
PEAK_TF32 = 495e12  # tensor cores, dense: for reference only
PEAK_BF16 = 989e12

H, W = 480, 640  # the city's frame (DEFAULT_SPEC)
FOCAL = 415.0


def _shapes() -> dict:
    from vo_tpu_torch.utils.config import VOConfig

    cfg = VOConfig()
    return dict(cap=cfg.capacity, lk_radius=cfg.klt.radius, lk_levels=cfg.klt.pyramid_levels,
                lk_iters=cfg.klt.max_iters, desc_d=(2 * cfg.descriptor.radius + 1) ** 2,
                pnp_hyp=cfg.pnp.num_hypotheses, pnp_gn=cfg.pnp.refine_iters,
                ba_w=cfg.ba.window, cfg=cfg)


def _time(fn, dev, reps: int) -> tuple[float | None, float | None]:
    """(events_ms, graph_ms) of one call: CUDA events around `reps` eager
    calls, and a CUDA graph of the calls replayed where fn can be captured
    (else None); (None, None) on the CPU, after one call."""
    import torch

    if dev.type != "cuda":
        fn()
        return None, None
    events = chip_smoke._time_ms(fn, reps)
    try:
        return events, chip_smoke._device_ms(fn, reps=min(reps, 20))
    except RuntimeError:  # a host sync inside fn: no capture
        torch.cuda.synchronize()
        return events, None


def roofline(dev, reps: int = 30) -> list[dict]:
    import torch

    from vo_tpu_torch.models.ba import ba_refine
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.ops.descriptors import match_descriptors
    from vo_tpu_torch.ops.harris import detect_keypoints
    from vo_tpu_torch.ops.image import build_pyramid
    from vo_tpu_torch.ops.klt import pyramidal_lk
    from vo_tpu_torch.ops.pnp import pnp_ransac
    from vo_tpu_torch.parallel.dist_ba import demo_window

    s = _shapes()
    cap, det = s["cap"], s["cfg"].detector
    rng = np.random.default_rng(2023)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    img = tensor(rng.uniform(0, 255, (H, W)))
    img2 = tensor(rng.uniform(0, 255, (H, W)))
    K_np = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    K = tensor(K_np)
    rows = []

    def add(name, fn, bytes_, flops, note=""):
        events_ms, graph_ms = _time(fn, dev, reps)
        t_ms = graph_ms if graph_ms is not None else events_ms
        how = "graph" if graph_ms is not None else "events" if t_ms is not None else "cpu"
        t_bw, t_f32 = bytes_ / HBM_BYTES_PER_S, flops / PEAK_F32
        bound_ms = 1e3 * max(t_bw, t_f32)
        rows.append(dict(
            kernel=name, ms=t_ms, timed_by=how, events_ms=events_ms, graph_ms=graph_ms,
            mbytes=bytes_ / 1e6, mflops=flops / 1e6,
            bw_bound_ms=1e3 * t_bw, f32_bound_ms=1e3 * t_f32,
            tf32_ms=1e3 * flops / PEAK_TF32, bf16_ms=1e3 * flops / PEAK_BF16,
            bound_ms=bound_ms, bound_by="bytes" if t_bw >= t_f32 else "operations",
            sol_pct=None if t_ms is None else 100.0 * bound_ms / t_ms, note=note))

    # ---- 1. Detection: response + NMS (K1) + top-K -------------------------
    px = H * W
    # One f32 image read + response write + NMS-mask read/write + top-K
    # gather (~1 more pass): 4 image passes. Per pixel: Sobel x/y (2x9 MACs),
    # 3 box-sum channels (separable 2x7 adds each), response (~10): ~100 flop.
    add(f"detect(shi_tomasi+nms+top{cap})",
        lambda: detect_keypoints(img, cap, patch_size=det.patch_size,
                                 nms_radius=det.nms_radius, border=det.border,
                                 quality_level=det.quality_level),
        4 * px * 4, 100 * px)

    # K1 alone: reads the image once, writes the map once (chip_smoke.py).
    add("K1 corner_response_nms (kernel)",
        lambda: kernels.corner_response_nms(img, "shi_tomasi", det.patch_size, det.kappa,
                                            det.nms_radius),
        2 * px * 4, px * chip_smoke.K1_FLOP_PER_PIXEL, "kernel bound, PERF.md section 6")

    # ---- 2. Pyramidal LK, cap points, the config's levels and iterations --
    levels, radius, iters = s["lk_levels"], s["lk_radius"], s["lk_iters"]
    pyr1, pyr2 = build_pyramid(img, levels), build_pyramid(img2, levels)
    xy = tensor(np.stack([rng.uniform(20, W - 20, cap), rng.uniform(20, H - 20, cap)], -1))
    add(f"pyramidal_lk({cap}pts,{levels}lvl,{iters}it)",
        lambda: pyramidal_lk(pyr1, pyr2, xy, radius=radius, max_iters=iters),
        # Per level: template patch gather (K*win) + per ITER a warped patch
        # gather (K*win); each resample reads a (2r+2)^2 source tile.
        levels * cap * ((2 * radius + 2) ** 2 + iters * (2 * radius + 2) ** 2) * 4,
        # Per iter and point: bilinear resample (win*8), gradients (win*4),
        # G and b accumulation (win*10) ~= 22*win, + the 2x2 solve ~20.
        levels * cap * iters * (22 * (2 * radius + 1) ** 2 + 20))

    # K2: the template and search windows of LK level 0 in one launch, on the
    # unpadded level (chip_smoke.py's pair model: both patch sets written
    # once, the pixels gathered read once, at most the whole level each).
    pad, t_size, s_size = chip_smoke.LK_PAD, chip_smoke.LK_TSIZE, chip_smoke.LK_SSIZE
    cor = rng.integers(0, [W, H], (cap, 2)) + pad
    tcor = torch.as_tensor((cor - chip_smoke.LK_CORNER_OFFSET[t_size]).astype(np.int32),
                           device=dev)
    scor = torch.as_tensor((cor - chip_smoke.LK_CORNER_OFFSET[s_size]).astype(np.int32),
                           device=dev)
    n_t, n_s = cap * t_size ** 2, cap * s_size ** 2
    add("K2 extract_patch_pairs level 0 (kernel)",
        lambda: kernels.extract_patch_pairs(img, img2, tcor, scor, t_size, s_size, pad),
        (n_t + n_s + min(n_t, px) + min(n_s, px) + 4 * cap) * 4, 0,
        "kernel bound, PERF.md section 6")

    # ---- 3. Descriptor matcher: (cap, D) x (cap, D) -----------------------
    d = s["desc_d"]
    d1, d2 = tensor(rng.normal(0, 1, (cap, d))), tensor(rng.normal(0, 1, (cap, d)))
    add(f"match_descriptors({cap}x{d})", lambda: match_descriptors(d1, d2),
        (2 * cap * d + cap * cap) * 4,  # read both, write the distances
        2 * cap * cap * d + 6 * cap * cap)  # the product + top-2 / mutual

    # ---- 4. PnP-RANSAC: hypotheses + GN iterations over cap points --------
    hyp, gn = s["pnp_hyp"], s["pnp_gn"]
    X_np = np.stack([rng.uniform(-8, 8, cap), rng.uniform(-4, 4, cap),
                     rng.uniform(8, 40, cap)], -1).astype(np.float32)
    uvh = (K_np @ X_np.T).T
    X, uv = tensor(X_np), tensor(uvh[:, :2] / uvh[:, 2:])
    gen = torch.Generator(device=dev).manual_seed(0)
    add(f"pnp_ransac({hyp}hyp+{gn}gn)",
        lambda: pnp_ransac(gen, X, uv, K, num_hypotheses=hyp, refine_iters=gn),
        # X/uv re-read per hypothesis tile of 64.
        (cap * 5 * 4) * (hyp // 64),
        # Hypotheses: quartic solve ~500 flop each; scoring: hyp x cap
        # projections (~25 flop); GN: iters x cap x (J 2x6 ~60 + JtJ 72).
        hyp * 500 + hyp * cap * 25 + gn * cap * 160)

    # ---- 5. One windowed-BA GN iteration (W, L = cap) ----------------------
    bw = s["ba_w"]
    win = demo_window(cap, bw, K_np, device=dev)
    lw = cap * bw
    add(f"ba_gn_iter(W={bw},L={cap})", lambda: ba_refine(win, K, iters=1),
        # The window's arrays read and written once (~2x); Jc/Jx spill.
        2 * (lw * (2 + 12 + 6 + 1) * 4 + cap * 3 * 4),
        # Residuals + Jacobians ~150 flop/obs; U/V/Wc einsums obs x (72+18+108);
        # Schur L x W^2 x 6x6x3 ~ L*W*W*324; the solve 36^3/3.
        lw * (150 + 200) + cap * bw * bw * 324 + 36 ** 3)
    return rows


def print_table(rows: list[dict], card: str) -> None:
    print(f"# roofline on {card} (HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s, f32 "
          f"{PEAK_F32 / 1e12:.0f} TFLOP/s; TF32 {PEAK_TF32 / 1e12:.0f}, BF16 "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s for reference)")
    print(f"{'part':42s}{'ms':>10s}{'by':>7s}{'MB':>8s}{'MFLOP':>9s}{'bw_ms':>10s}"
          f"{'f32_ms':>10s}{'bound':>11s}{'SoL%':>8s}")
    for r in rows:
        ms = "-" if r["ms"] is None else f"{r['ms']:.4f}"
        sol = "-" if r["sol_pct"] is None else f"{r['sol_pct']:.2f}"
        print(f"{r['kernel']:42s}{ms:>10s}{r['timed_by']:>7s}{r['mbytes']:8.2f}"
              f"{r['mflops']:9.1f}{r['bw_bound_ms']:10.5f}{r['f32_bound_ms']:10.5f}"
              f"{r['bound_by']:>11s}{sol:>8s}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; exits 2 without a GPU) or cpu, only when asked")
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--json", default="", help="also write the rows here")
    args = p.parse_args(argv)

    dev = common_torch.cuda_or_cpu(args.device, "roofline_torch")
    if dev is None:
        return 2
    card = bench_torch.card_name(dev)
    rows = roofline(dev, args.reps)
    print_table(rows, card)
    out = {"tool": "roofline_torch", "device": card, "rows": rows}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
        print(f"wrote {args.json}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
