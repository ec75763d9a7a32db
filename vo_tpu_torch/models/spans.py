"""Spans and counters of the captured step, on the card's own clock.

The frame's graph (models/graphed.py) holds a mark at every boundary of the
step's schedule (`pipeline.BOUNDARIES`): on the card a one-thread kernel,
`vo_span_mark<B>` of csrc/spans.cu, launched on the capturing stream, so
that it is a kernel node of the frame's graph or of R's or C's conditional
body. A mark reads `%globaltimer` and writes it into a device ring of rows,
one row a step, at the row of a device step counter; the frame-start mark
advances the counter and zeroes the row, so R's and C's columns stay 0 on a
step where their IF node did not run. The end mark copies the step's counts
into its row, and C's end mark BA's (`STEP_COUNTS`, `BA_COUNTS`): each summed
over lanes on the device, from values the step computes anyway. On the CPU
the stand-in's mark (`graphed.StandIn`) writes the host's monotonic clock
into the same ring.

The runner stamps each step's host phases (`STEP_PHASES`: the draws, the
frame's copy and the replay's launch, the output copies) into a host ring of
the same rows on `time.monotonic_ns`, and each rollout's copy-in and
copy-back (`Rollout`). It calibrates the card's clock against the host's
when it captures and again when read (`Ring.calibrate`), so that `statistics`
can say what the host was doing while the card waited between two steps.
A rollout run under torch.profiler is flagged and left out of every
statistic: it measures the tracer.

Nothing is read from the device during a rollout: the rings are read by
`Ring.readout`, after it.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

import numpy as np
import torch

from vo_tpu_torch.models.pipeline import BOUNDARIES

ROWS = 8192  # a 51 s window of either benchmark cell in about 1.3 MB
BOUNDARY = {b: i for i, b in enumerate(BOUNDARIES)}
# Written by the frame's end mark, each summed over lanes: the slots tracked
# (StepOutput.num_tracked), PnP's inputs (A's `tri`) and inliers
# (num_pnp_inliers), the triangulation's candidates (num_candidates) and new
# landmarks (num_new_landmarks); with LK, its point-iterations still active.
STEP_COUNTS = ("tracked", "pnp_inputs", "pnp_inliers", "tri_candidates", "new_landmarks",
               "lk_active")
# Written by C's end mark: the lanes on which C ran BA (those that push), and
# those of them whose refinement BA's accept veto kept.
BA_COUNTS = ("ba_runs", "ba_kept")
COLUMNS = ("seq", *(f"t.{b}" for b in BOUNDARIES), *STEP_COUNTS, *BA_COUNTS)
COL = {c: i for i, c in enumerate(COLUMNS)}
STEP_PHASES = ("draw", "launch", "copy_out")
HOST_COLUMNS = ("seq", "profiled", *STEP_PHASES, "done")  # a phase's column: its start
HCOL = {c: i for i, c in enumerate(HOST_COLUMNS)}
CALIBRATION_TRIPS = 16
# Nodes that spans add to the frame's graph, its bodies included, as read
# on the card (a test there holds the count): the 11 marks (7 in the frame,
# R's 2 and C's 2 in their bodies) and 11 kernels of the counters' sums and
# stacks (7 in the frame for LK's masks and the step's counts, 4 in C's body
# for BA's).
ADDED_NODES = 22


class Rollout(NamedTuple):
    """One rollout's host stamps (ns, `time.monotonic_ns`)."""

    first: int  # the sequence number of its first step
    steps: int
    profiled: bool
    copy_in: int  # the caller's state and K copied into the static ones
    copy_in_end: int
    copy_back: int  # the final state copied out
    done: int


class Calibration(NamedTuple):
    """The card's clock against the host's, from the narrowest of
    `CALIBRATION_TRIPS` round trips of a clock reading on the device, a
    synchronize and a host reading."""

    host_ns: int  # the middle of that round trip, host clock
    offset_ns: int  # card clock minus host clock
    uncertainty_ns: float  # half that round trip
    tick_ns: int  # the smallest non-zero step of the card's clock seen


class Readout(NamedTuple):
    """A runner's rings as read after its rollouts."""

    table: np.ndarray  # (ROWS, COLUMNS) the device ring
    host: np.ndarray  # (ROWS, HOST_COLUMNS) the host ring
    rollouts: list  # [Rollout]
    calibrations: list  # [Calibration]: at capture, and when read
    steps: int  # steps replayed (the last sequence number)
    per_step: dict  # work a step offers: "slots", "lk_run", "pnp_hypotheses"


class Ring:
    """A runner's device ring (rows of `COLUMNS`, int64), its step counter
    and clock buffer, and the host ring and rollout stamps beside them."""

    def __init__(self, device: torch.device, rows: int = ROWS):
        self.table = torch.zeros((rows, len(COLUMNS)), dtype=torch.int64, device=device)
        self.seq = torch.zeros(1, dtype=torch.int64, device=device)
        self.clock = torch.zeros(2, dtype=torch.int64, device=device)
        self.host = np.zeros((rows, len(HOST_COLUMNS)), dtype=np.int64)
        self.rollouts: collections.deque = collections.deque(maxlen=rows)
        self.steps = 0
        self.calibrations: list = []

    @property
    def rows(self) -> int:
        return self.table.shape[0]

    def reset(self) -> None:
        """Forget every step (the warm-up's and the capture's marks)."""
        self.table.zero_()
        self.seq.zero_()
        self.host[:] = 0
        self.rollouts.clear()
        self.steps = 0

    def step(self, profiled: bool) -> np.ndarray:
        """The host row of the next step, whose frame-start mark will advance
        the device's counter to the same number."""
        self.steps += 1
        row = self.host[self.steps % self.rows]
        row[:] = 0
        row[HCOL["seq"]], row[HCOL["profiled"]] = self.steps, profiled
        return row

    def calibrate(self, capture) -> Calibration:
        """Read the card's clock (`capture.clock`) between two host readings,
        `CALIBRATION_TRIPS` times; keep the narrowest trip. The first
        calibration is kept, the latest replaces the one before it."""
        trips = []
        for _ in range(CALIBRATION_TRIPS):
            h0 = time.monotonic_ns()
            capture.clock(self.clock)
            if self.clock.is_cuda:
                torch.cuda.synchronize(self.clock.device)
            h1 = time.monotonic_ns()
            d0, d1 = self.clock.tolist()
            trips.append((h1 - h0, h0, d0, d1 - d0))
        width, h0, d0, _ = min(trips)
        ticks = [t for *_, t in trips if t > 0]
        middle = h0 + width // 2
        cal = Calibration(middle, d0 - middle, width / 2, min(ticks) if ticks else 0)
        self.calibrations = self.calibrations[:1] + [cal]
        return cal

    def readout(self, per_step: dict) -> Readout:
        """The rings as they stand (one read of the device's)."""
        return Readout(self.table.cpu().numpy(), self.host.copy(), list(self.rollouts),
                       list(self.calibrations), self.steps, dict(per_step))


def host_mark(ring: Ring, boundary: int, src: torch.Tensor | None, dst: int) -> None:
    """The mark kernel's twin on the host's monotonic clock, over the same
    ring (the stand-in's: see csrc/spans.cu)."""
    t = time.monotonic_ns()
    if boundary == 0:
        ring.seq += 1
    s = int(ring.seq[0])
    row = ring.table[s % ring.rows]
    if boundary == 0:
        row.zero_()
        row[0] = s
    row[1 + boundary] = t
    if src is not None:
        row[dst:dst + src.numel()] = src


def host_clock(out: torch.Tensor) -> None:
    """The clock kernel's twin: a host reading and the first that differs."""
    t0 = t1 = time.monotonic_ns()
    while t1 == t0:
        t1 = time.monotonic_ns()
    out[0], out[1] = t0, t1


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

SEGMENTS = ("track", "localize", "recover", "locate", "eigh", "map", "keyframe", "finish")
IDLE_PHASES = (*STEP_PHASES, "copy_in", "copy_back", "caller")


def _stamp(t: np.ndarray, boundary: str) -> np.ndarray:
    return t[:, COL[f"t.{boundary}"]]


def segments_ns(t: np.ndarray) -> dict:
    """Each segment's device ns a row, the rows' stamps tiled end to end:
    R's and C's bodies (0 where they did not run); B1 from A's end to its
    own, less R; D from B2's end to the frame's, less C. A branch's
    predicate and IF node count with the segment after it."""
    s = {b: _stamp(t, b) for b in BOUNDARIES}
    rec = np.where(s["R.start"] > 0, s["R.end"] - s["R.start"], 0)
    kf = np.where(s["C.start"] > 0, s["C.end"] - s["C.start"], 0)
    return dict(track=s["track"] - s["start"], localize=s["localize"] - s["track"],
                recover=rec, locate=s["locate"] - s["localize"] - rec,
                eigh=s["eigh"] - s["locate"], map=s["map"] - s["eigh"], keyframe=kf,
                finish=s["end"] - s["map"] - kf)


def to_host_ns(d: np.ndarray, calibrations: list) -> np.ndarray:
    """Card clock -> host clock: the offset interpolated linearly (in card
    time) between the first and the latest calibration."""
    first, last = calibrations[0], calibrations[-1]
    d0, d1 = first.host_ns + first.offset_ns, last.host_ns + last.offset_ns
    if d1 == d0:
        return d - first.offset_ns
    w = (d - d0) / (d1 - d0)
    return d - (first.offset_ns + w * (last.offset_ns - first.offset_ns))


def _host_intervals(r: Readout, seqs: np.ndarray) -> tuple:
    """(starts, ends, phase indices) of every host phase the rings hold, in
    order: the steps' and the rollouts' copies."""
    h = r.host[seqs % len(r.host)]
    h = h[h[:, HCOL["seq"]] == seqs]
    parts = []
    bounds = (*STEP_PHASES, "done")
    for i, phase in enumerate(STEP_PHASES):
        a, b = h[:, HCOL[phase]], h[:, HCOL[bounds[i + 1]]]
        parts.append((a, b, np.full(len(a), IDLE_PHASES.index(phase))))
    for name, a, b in (("copy_in", "copy_in", "copy_in_end"), ("copy_back", "copy_back", "done")):
        ra = np.array([getattr(x, a) for x in r.rollouts], dtype=np.int64)
        rb = np.array([getattr(x, b) for x in r.rollouts], dtype=np.int64)
        parts.append((ra, rb, np.full(len(ra), IDLE_PHASES.index(name))))
    a, b, p = (np.concatenate(x) for x in zip(*parts))
    keep = (a > 0) & (b >= a)
    order = np.argsort(a[keep], kind="stable")
    return a[keep][order], b[keep][order], p[keep][order]


def assign(gaps: np.ndarray, intervals: tuple) -> np.ndarray:
    """ns of the host gaps (n, 2) spent in each of `IDLE_PHASES`: the
    overlap with each host phase, the rest the caller's. The intervals are
    the host's own, one after another."""
    starts, ends, phase = intervals
    out = np.zeros(len(IDLE_PHASES))
    for a, b in gaps:
        lo = np.searchsorted(ends, a, "right")
        hi = np.searchsorted(starts, b, "left")
        over = np.minimum(ends[lo:hi], b) - np.maximum(starts[lo:hi], a)
        over = np.clip(over, 0, None)
        np.add.at(out, phase[lo:hi], over)
        out[-1] += max(0.0, (b - a) - over.sum())
    return out


def _round(x: float) -> float:
    return float(f"{x:.6g}")


def statistics(readouts: list) -> dict | None:
    """Aggregates over the counted steps of every readout (a runner's): a
    step is counted where its device row and host row are both in the rings
    and it did not run under the profiler. None without a counted step."""
    seg_ns = {k: [] for k in SEGMENTS}
    span, ran_r, ran_c, host_ns, counts = [], [], [], [], []
    idle = np.zeros(len(IDLE_PHASES))
    gap_ns = wall_ns = 0.0
    left_out = wrapped = 0
    offered = collections.Counter()
    for r in readouts:
        rows = len(r.table)
        seqs = np.arange(max(1, r.steps - rows + 1), r.steps + 1)
        wrapped += max(0, r.steps - rows)
        dev, host = r.table[seqs % rows], r.host[seqs % rows]
        start, end = _stamp(dev, "start"), _stamp(dev, "end")
        counted = ((dev[:, 0] == seqs) & (host[:, HCOL["seq"]] == seqs) & (start > 0)
                   & (end >= start) & (host[:, HCOL["profiled"]] == 0))
        left_out += int(len(seqs) - counted.sum())
        if not counted.any():
            continue
        dev_c, host_c = dev[counted], host[counted]
        for k, v in segments_ns(dev_c).items():
            seg_ns[k].append(v)
        span.append(_stamp(dev_c, "end") - _stamp(dev_c, "start"))
        ran_r.append(_stamp(dev_c, "R.start") > 0)
        ran_c.append(_stamp(dev_c, "C.start") > 0)
        host_ns.append(np.diff(host_c[:, [HCOL[c] for c in (*STEP_PHASES, "done")]], axis=1))
        counts.append(dev_c[:, [COL[c] for c in STEP_COUNTS + BA_COUNTS]].sum(axis=0))
        for k, v in r.per_step.items():
            offered[k] += v * int(counted.sum())
        # Gaps between two counted steps in a row: the card outside the graph.
        pair = counted[:-1] & counted[1:]
        a, b = end[:-1][pair], start[1:][pair]
        gap_ns += float((b - a).sum())
        wall_ns += float(span[-1].sum()) + float((b - a).sum())
        if pair.any() and r.calibrations:
            gaps = np.stack([to_host_ns(a, r.calibrations), to_host_ns(b, r.calibrations)], 1)
            idle += assign(gaps, _host_intervals(r, seqs))
    if not span:
        return None
    span = np.concatenate(span)
    n = len(span)
    seg = {k: np.concatenate(v) for k, v in seg_ns.items()}
    ran = {"recover": np.concatenate(ran_r), "keyframe": np.concatenate(ran_c)}
    host = np.concatenate(host_ns)
    total = np.sum(counts, axis=0)
    cals = [(r.calibrations[0], r.calibrations[-1]) for r in readouts if r.calibrations]
    return dict(
        steps=n, left_out=left_out, wrapped=wrapped,
        segment_ms={k: _round(v.mean() * 1e-6) for k, v in seg.items()},
        branch_steps={k: int(v.sum()) for k, v in ran.items()},
        branch_ms={k: _round(seg[k][v].mean() * 1e-6) if v.any() else None
                   for k, v in ran.items()},
        step_ms=dict(mean=_round(span.mean() * 1e-6),
                     p95=_round(float(np.percentile(span, 95)) * 1e-6)),
        device_idle_pct=_round(100.0 * gap_ns / wall_ns) if wall_ns > 0 else None,
        device_idle_ms=_round(gap_ns * 1e-6), device_wall_ms=_round(wall_ns * 1e-6),
        idle_host_ms={k: _round(v * 1e-6) for k, v in zip(IDLE_PHASES, idle)},
        host_ms={k: _round(v * 1e-6) for k, v in zip(STEP_PHASES, host.mean(axis=0))},
        counts={**{k: int(v) for k, v in zip(STEP_COUNTS + BA_COUNTS, total)},
                **{k: int(v) for k, v in offered.items()}},
        clock=dict(
            offset_ns=cals[-1][1].offset_ns,
            uncertainty_ns=_round(max(last.uncertainty_ns for _, last in cals)),
            drift_ns=max(abs(last.offset_ns - first.offset_ns) for first, last in cals),
            drift_over_s=_round(max((last.host_ns - first.host_ns) * 1e-9
                                    for first, last in cals)),
            tick_ns=min(last.tick_ns for _, last in cals)) if cals else None,
    )
