#!/usr/bin/env python
"""Time the port's hand-written kernels at the main path's shapes on one CUDA
GPU, for THIS tree or for another checkout of the port (`--tree`), so that two
commits can be compared on one card inside one call:

    python tools/time_kernels_torch.py                      # this tree
    python tools/time_kernels_torch.py --tree .dev/parent   # an unpacked commit
    python tools/time_kernels_torch.py --tiles 64x40x512,64x32x512,32x32x256

Timed, each as `ms` (CUDA events around 50 eager calls: what the path pays,
host enqueue included) and `device_ms` (the same calls captured in a CUDA
graph and replayed: what the device needs):

  * an empty launch through the ctypes path;
  * the corner kernel at (480, 640) and (6, 480, 640), shi_tomasi, patch 7,
    r 8;
  * the patch gathers of one LK level at level 0 of a 640x480 frame, K = 1024
    on one lane and K = 512 on six: `extract_patch_pairs` where the tree has
    it (one launch, unpadded levels), else the two edge-replicated copies and
    the two `extract_patches` launches that a tree without it makes a level;
    for a tree with the pair also those two launches alone on levels padded
    beforehand.

`--tiles WxHxTHREADS,...` rebuilds the corner kernel with each tile and block
size (the -D flags of csrc/corner_nms.cu; a library of its own per set of
flags), checks it bit for bit against the default build and times it.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the timing helpers; imports nothing of the port)

LANES, K_SINGLE, K_LANES = 6, 1024, 512
LEVEL0 = (480, 640)
TSIZE, SSIZE, PAD = 21, 35, 18


def _both(fn) -> dict:
    import torch

    ms = 0.5 * (chip_smoke._time_ms(fn) + chip_smoke._time_ms(fn))
    try:
        return {"ms": ms, "device_ms": chip_smoke._device_ms(fn)}
    except RuntimeError as exc:  # a wrapper that cannot be captured in a graph
        torch.cuda.synchronize()
        return {"ms": ms, "device_ms": None, "capture_error": str(exc).splitlines()[0]}


def _lk_corners(rng, lead, k, offset, dev):
    import torch

    h, w = LEVEL0
    cor = np.stack([rng.integers(0, w, lead + (k,)), rng.integers(0, h, lead + (k,))], -1)
    return torch.as_tensor((cor + PAD - offset).astype(np.int32), device=dev)


def time_tree(dev) -> dict:
    import torch
    from vo_tpu_torch.ops import kernels

    rng = np.random.default_rng(3)
    out = {"empty_launch": _both(lambda: kernels.empty_launch(dev))}
    for tag, shape in (("k1", LEVEL0), ("k1b", (LANES,) + LEVEL0)):
        img = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32), device=dev)
        out[tag] = _both(lambda: kernels.corner_response_nms(
            img, "shi_tomasi", 7, 0.08, 8, use_kernel=True))
        if hasattr(kernels, "corner_nms_launch_info"):
            out[tag]["launch"] = kernels.corner_nms_launch_info(7, 8, dev)
    has_pair = hasattr(kernels, "extract_patch_pairs")
    if has_pair:
        pad_replicate = kernels.pad_replicate
    else:
        from vo_tpu_torch.ops.klt import _pad_replicate as pad_replicate
    for tag, lead, k in (("level_gathers", (), K_SINGLE), ("level_gathers_6", (LANES,), K_LANES)):
        prev = torch.as_tensor(rng.uniform(0, 255, lead + LEVEL0).astype(np.float32), device=dev)
        nxt = torch.as_tensor(rng.uniform(0, 255, lead + LEVEL0).astype(np.float32), device=dev)
        tcor = _lk_corners(rng, lead, k, 10, dev)
        scor = _lk_corners(rng, lead, k, 16, dev)

        def two_launches(p, n):
            return (kernels.extract_patches(p, tcor, TSIZE, use_kernel=True),
                    kernels.extract_patches(n, scor, SSIZE, use_kernel=True))

        def pads_and_two_launches():
            return two_launches(pad_replicate(prev, PAD), pad_replicate(nxt, PAD))

        if has_pair:
            def pair():
                return kernels.extract_patch_pairs(prev, nxt, tcor, scor, TSIZE, SSIZE, PAD,
                                                   use_kernel=True)

            want = pads_and_two_launches()
            got = pair()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{tag}: the pair differs from pads + two launches")
            prev_p, nxt_p = pad_replicate(prev, PAD), pad_replicate(nxt, PAD)
            out[tag] = {"way": "extract_patch_pairs, one launch", **_both(pair),
                        "two_launches_prepadded": _both(lambda: two_launches(prev_p, nxt_p)),
                        "pads_and_two_launches": _both(pads_and_two_launches)}
        else:
            out[tag] = {"way": "two pad_replicate + two extract_patches",
                        **_both(pads_and_two_launches)}
    return out


def time_tiles(dev, specs: list[str]) -> dict:
    """The corner kernel rebuilt with other tiles: bit-identity with the
    default build, then times by direct calls of the C launcher."""
    import torch
    from vo_tpu_torch.ops import _build, kernels

    rng = np.random.default_rng(4)
    imgs = torch.as_tensor(rng.uniform(0, 255, (LANES,) + LEVEL0).astype(np.float32), device=dev)
    want = kernels.corner_response_nms(imgs, "shi_tomasi", 7, 0.08, 8, use_kernel=True)
    out = {}
    for spec in specs:
        tw, th, threads = (int(v) for v in spec.split("x"))
        lib = _build.load(_build.build((f"-DVO_K1_TILE_W={tw}", f"-DVO_K1_TILE_H={th}",
                                        f"-DVO_K1_THREADS={threads}")))
        info = (ctypes.c_int * 7)()
        if lib.vo_corner_nms_launch_info(7, 8, info) != 0:
            raise RuntimeError(f"tile {spec}: no launch information")
        res = {"smem_bytes": info[4], "blocks_per_sm": info[5]}
        for tag, x in (("k1", imgs[0]), ("k1b", imgs)):
            x = x.contiguous()
            b = x.numel() // (LEVEL0[0] * LEVEL0[1])
            got = torch.empty_like(x)

            def launch():
                err = lib.vo_corner_response_nms(
                    x.data_ptr(), got.data_ptr(), b, LEVEL0[0], LEVEL0[1], 0, 7, 0.08, 8,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"tile {spec}: launch failed with cudaError {err}")

            launch()
            torch.cuda.synchronize()
            if not torch.equal(got.reshape(want[:b].shape), want[:b]):
                raise RuntimeError(f"tile {spec}: differs from the default build")
            res[tag] = _both(launch)
        out[spec] = res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=None,
                   help="directory that holds the vo_tpu_torch package to time "
                        "(default: the tree this script is in)")
    p.add_argument("--tiles", default="",
                   help="comma-separated WxHxTHREADS corner-kernel tiles to rebuild and time")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_kernels_torch: no CUDA device visible", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    import vo_tpu_torch

    if Path(vo_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"time_kernels_torch: vo_tpu_torch was imported from {vo_tpu_torch.__file__}, "
              f"not from {tree}", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = chip_smoke._card_line()
    print(f"[card] {card}")
    result = {"tree": str(args.tree or "."), "card": card, **time_tree(dev)}
    if args.tiles:
        result["tiles"] = time_tiles(dev, args.tiles.split(","))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
