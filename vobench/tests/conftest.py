"""Shared helpers of the benchmark's CPU tests: cells at a size the CPU
steps in seconds, built from the real configuration and mix files."""

from __future__ import annotations

import copy

from vobench import registry


def tiny_cell(config: str, traffic: str, frames: int = 90, copies: int | None = None,
              width: int = 160, height: int = 120, capacity: int = 128,
              limits: dict | None = None, cell: str | None = None) -> registry.Cell:
    """Cell `<config>.<traffic>` with its lanes cut to `width` x `height`
    (focal scaled with the width) and `frames` frames, `capacity` slots,
    and `copies` lanes where given; the limits of the real cell unless
    given."""
    cfg = copy.deepcopy(registry.config(config))
    for ln in cfg["lanes"]:
        ln["focal"] = ln["focal"] * width / ln["width"]
        ln.update(width=width, height=height, num_frames=frames)
    cfg["vo"]["capacity"] = capacity
    name = cell or f"{config}.{traffic}"
    bench = registry.cell(name)
    mix = dict(bench.traffic, copies=copies) if copies else bench.traffic
    return bench._replace(config=cfg, traffic=mix,
                          limits=limits if limits is not None else bench.limits)
