"""How `correct` is decided: what the window produced, judged against the
plain reference (reference.py) and the exact ground truth of the
benchmark's city, after the window has closed.

The answers are the program's own, as the timed path left them: every
frame's pose and pose_ok (each lane, each pass), and the feature table
after every chunk (positions, landmarks, uids, states and the detector
responses of the corners born on the chunk's last frame). The traffic
cuts every pass into chunks of 15 frames and 1, so every 16th frame is a
chunk of its own: the tables before and after it are a probe of one step
of the front end. The numbers, each the worst over the lanes, each held
to a limit of the cell's own (`limits/<cell>.json`, set from the readings
that PERF.md gives):

- `nonfinite_poses` (the step): stepped poses that are not finite; 0.
- `seg_err_med_m`, `seg_err_p95_m` (solvers, the trajectory frame by
  frame): each pass's stepped frames cut into segments of SEGMENT frames,
  each segment's poses Sim(3)-aligned to the ground truth on its own (the
  benchmark's copy of evaluate.py), then for every pair of consecutive
  frames of a segment the distance between the aligned and the true
  motion, in metres; the median and the 95th percentile over the frames.
  A segment is short enough that the scale a monocular run drifts in over
  a pass does not count, and long enough that its alignment is well
  posed. The 95th percentile catches a fault on a few frames in twenty.
- `lk_gap_px` (front end, the K2 gathers): at every probe, each slot the
  program tracked through the frame (the same uid before and after,
  tracked after) against where the reference's Lucas-Kanade, in float64,
  tracks it from the table before the frame on the benchmark's own frames;
  the LK_QUANTILE-th percentile of the distances, in pixels. The
  reference follows the program's state: the table before the frame, and
  the poses that seed the guess.
- `k1_gap` (K1's response): the response the table keeps for each corner
  born on a chunk's last frame (the kernel's output at that pixel),
  against the plain Shi-Tomasi response in float64 there; the largest
  relative gap.
- `k1_nms_gap` (K1's suppression): for the same corners, how far the
  float64 response's largest value in the corner's suppression window
  lies above the response at the corner, relative; the largest.

A number that is not finite, or that has nothing to read, fails.

The control (`numbers(..., control=True)`): the reference put in the
program's place and computed in bfloat16, the precision below the float32
the configuration states: the true poses and the reference's tracked
positions rounded to bfloat16, the responses computed in it, and each
corner moved to the largest bfloat16 response of its window. The
reference's tracking starts, for both, from the program's table and poses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vobench import evaluate, reference

SEGMENT = 32  # frames a segment; a shorter tail of a pass is not aligned
LK_QUANTILE = 99.0
# The numbers held to limits; `numbers` gives some more for the record.
NAMES = ("nonfinite_poses", "seg_err_med_m", "seg_err_p95_m", "lk_gap_px", "k1_gap",
         "k1_nms_gap")


class Boundary(NamedTuple):
    frame: int  # the frame after which the table was kept
    xy: np.ndarray  # (B, K, 2)
    uid: np.ndarray  # (B, K)
    state: np.ndarray  # (B, K)
    score: np.ndarray  # (B, K)
    landmark: np.ndarray  # (B, K, 3)


class PassAnswers(NamedTuple):
    frames: np.ndarray  # (n,) the frames stepped
    pose: np.ndarray  # (n, B, 4, 4)
    pose_ok: np.ndarray  # (n, B)
    complete: bool
    boundaries: list  # [Boundary]


def _lanes(x: torch.Tensor, lanes: int, lead: int) -> np.ndarray:
    """A program tensor with its lane axis at `lead` (added for one lane)."""
    a = x.detach().cpu().numpy()
    return a if lanes > 1 else np.expand_dims(a, lead)


def collect(window, lanes: int) -> list[PassAnswers]:
    """The window's answers copied to the host."""
    out = []
    for p in window.passes:
        if not p.chunks:
            continue
        frames, poses, oks, bounds = [], [], [], []
        for c in p.chunks:
            n = c.outs.pose.shape[0]
            frames.append(np.arange(c.first, c.first + n))
            poses.append(_lanes(c.outs.pose, lanes, 1))
            oks.append(_lanes(c.outs.pose_ok, lanes, 1))
            t = c.table
            bounds.append(Boundary(c.first + n - 1, *(_lanes(x, lanes, 0) for x in (
                t.xy, t.uid, t.state, t.score, t.landmark))))
        out.append(PassAnswers(np.concatenate(frames), np.concatenate(poses).astype(np.float64),
                               np.concatenate(oks), p.complete, bounds))
    return out


def trajectory(boot_pose: np.ndarray, p: PassAnswers, lane: int, boot_frames) -> tuple:
    """(estimated poses, frame numbers) of one lane of a pass: the first
    bootstrap frame (identity), the second (the bootstrap's pose), then the
    frames stepped."""
    est = np.concatenate([np.eye(4)[None], boot_pose[None].astype(np.float64),
                          p.pose[:, lane]])
    return est, np.concatenate([np.asarray(boot_frames), p.frames])


def ate_sq_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Squared position errors after one Sim(3) alignment of est to gt;
    inf for every frame where a pose is not finite."""
    e, g = est[:, :3, 3], gt[:, :3, 3].astype(np.float64)
    if not np.isfinite(e).all():
        return np.full(len(e), np.inf)
    s, R, t = evaluate.align_umeyama(e, g)
    aligned = (s * (R @ e.T)).T + t
    return ((aligned - g) ** 2).sum(-1)


def segment_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """|aligned motion - true motion| between consecutive frames of
    (n, 4, 4) poses, in consecutive SEGMENT-frame segments, each Sim(3)-
    aligned to gt on its own; inf for every frame where a pose is not
    finite."""
    e, g = est[:, :3, 3], gt[:, :3, 3].astype(np.float64)
    if not np.isfinite(e).all():
        return np.full(len(e), np.inf)
    out = []
    for lo in range(0, len(e) - SEGMENT + 1, SEGMENT):
        es, gs = e[lo:lo + SEGMENT], g[lo:lo + SEGMENT]
        s, R, _ = evaluate.align_umeyama(es, gs)
        out.append(np.linalg.norm(s * (np.diff(es, axis=0) @ R.T) - np.diff(gs, axis=0),
                                  axis=1))
    return np.concatenate(out) if out else np.array([])


def born(b: Boundary, lane: int) -> np.ndarray:
    """Slots holding a corner detected on the boundary's own frame: still
    unmatched, on the integer grid the detector reports (a restarted
    track keeps its tracked, subpixel position)."""
    xy = b.xy[lane]
    return (b.state[lane] == 0) & (xy == np.round(xy)).all(-1) & (b.score[lane] > 0)


class _Frames:
    """The reference's per-frame products of the benchmark's own frames,
    each made once: Shi-Tomasi responses in float64 and bfloat16 with their
    suppression windows' maxima, and float64 pyramids."""

    def __init__(self, setup):
        self.setup = setup
        self.cache: dict = {}

    def get(self, kind: str, frame: int, lane: int):
        key = (kind, frame, lane)
        if key not in self.cache:
            img = self.setup.frames[frame, lane]
            cfg = self.setup.cfg
            if kind == "pyramid":
                v = reference.build_pyramid(img, cfg.klt.pyramid_levels)
            elif kind in ("resp64", "resp16"):
                dt = torch.float64 if kind == "resp64" else torch.bfloat16
                r = reference.corner_response(img, cfg.detector.patch_size, dt).double()
                v = (r, reference.window_max(r, cfg.detector.nms_radius))
            self.cache[key] = v
        return self.cache[key]

    def drop(self, frame: int) -> None:
        for key in [k for k in self.cache if k[1] < frame]:
            del self.cache[key]


def _pixel(r: torch.Tensor, xy: np.ndarray) -> np.ndarray:
    """Values of an (H, W) map at integer pixels xy (K, 2); NaN off it."""
    h, w = r.shape
    ix, iy = xy[:, 0].astype(np.int64), xy[:, 1].astype(np.int64)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = np.full(len(xy), np.nan)
    idx = torch.as_tensor(iy[inside] * w + ix[inside], device=r.device)
    out[inside] = r.reshape(-1)[idx].cpu().numpy()
    return out


def _window_argmax(r: torch.Tensor, xy: np.ndarray, radius: int) -> np.ndarray:
    """For each integer pixel of xy (K, 2), the pixel of the largest value
    of r in its (2 radius + 1)^2 window (among equals the largest flat
    index, as K1's suppression breaks ties)."""
    h, w = r.shape
    d = torch.arange(-radius, radius + 1, device=r.device)
    x = torch.as_tensor(xy[:, 0].astype(np.int64), device=r.device)
    y = torch.as_tensor(xy[:, 1].astype(np.int64), device=r.device)
    xs = (x[:, None, None] + d[None, None, :]).clamp(0, w - 1)
    ys = (y[:, None, None] + d[None, :, None]).clamp(0, h - 1)
    flat = (ys * w + xs).reshape(len(xy), -1)
    v = r.reshape(-1)[flat]
    best = torch.where(v == v.max(-1, keepdim=True).values, flat, -1).max(-1).values
    return torch.stack([best % w, best // w], -1).cpu().numpy().astype(np.float64)


def _lk_probe(setup, frames: _Frames, p: PassAnswers, a: Boundary, b: Boundary,
              lane: int) -> tuple:
    """(program's, reference's) tracked positions (n, 2) of the slots
    tracked through frame b.frame = a.frame + 1."""
    same = (a.uid[lane] == b.uid[lane]) & (a.state[lane] >= 0) & (b.state[lane] >= 1)
    if not same.any():
        return np.zeros((0, 2)), np.zeros((0, 2))
    dev = setup.frames.device
    cfg = setup.cfg
    i = int(np.searchsorted(p.frames, a.frame))
    t64 = dict(dtype=torch.float64, device=dev)
    xy = torch.as_tensor(a.xy[lane][same], **t64)
    if cfg.klt.predict_motion:
        guess = reference.flow_guess(
            xy, torch.as_tensor(a.state[lane][same], device=dev),
            torch.as_tensor(a.landmark[lane][same], **t64),
            torch.as_tensor(p.pose[i, lane], **t64), torch.as_tensor(p.pose[i - 1, lane], **t64),
            torch.as_tensor(setup.Ks[lane], **t64))
    else:
        guess = torch.zeros_like(xy)
    k = cfg.klt
    ref, _ = reference.pyramidal_lk(
        frames.get("pyramid", a.frame, lane), frames.get("pyramid", b.frame, lane), xy, guess,
        k.radius, k.max_iters, k.eps, k.max_err, k.min_eig_threshold)
    return b.xy[lane][same], ref.cpu().numpy()


def _k1(setup, frames: _Frames, b: Boundary, lane: int, side: str) -> tuple:
    """(response gaps, suppression gaps) of the corners born on b's frame."""
    mask = born(b, lane)
    if not mask.any():
        return np.array([]), np.array([])
    xy = b.xy[lane][mask]
    r64, m64 = frames.get("resp64", b.frame, lane)
    if side == "control":
        r16, _ = frames.get("resp16", b.frame, lane)
        xy = _window_argmax(r16, xy, setup.cfg.detector.nms_radius)
        score = _pixel(r16, xy)
    else:
        score = b.score[lane][mask]
    ref = _pixel(r64, xy)
    scale = np.maximum(np.abs(ref), 1e-30)
    value = np.abs(score - ref) / scale
    nms = (_pixel(m64, xy) - ref) / scale
    return (np.where(np.isfinite(value), value, np.inf),
            np.where(np.isfinite(nms), nms, np.inf))


def _worst(per_lane: list, fn) -> float:
    """fn of each lane's values, the largest over the lanes: inf where a
    lane holds a value that is not finite, NaN where one holds none."""
    vals = []
    for v in per_lane:
        a = np.concatenate(v) if v else np.array([])
        vals.append(np.nan if not a.size else fn(a) if np.isfinite(a).all() else np.inf)
    return float(np.max(vals)) if vals else np.nan


def numbers(setup, answers: list[PassAnswers], control: bool = False) -> dict:
    """The numbers of the comparison (module docstring) of the program's
    answers; with `control`, {"program": ..., "control": ...}, the control's
    numbers beside them, read from the same reference at the same cost."""
    if any(setup.cfg.dist):
        raise NotImplementedError("the reference's tracking guess assumes no lens distortion")
    sides = ("program", "control") if control else ("program",)
    lanes = setup.n_lanes
    frames = _Frames(setup)
    got = {side: {k: [[] for _ in range(lanes)] for k in ("seg", "lk", "k1", "nms")}
           for side in sides}
    nonfinite = dict.fromkeys(sides, 0)
    for p in answers:
        for b_prev, b in zip([None] + p.boundaries[:-1], p.boundaries):
            for lane in range(lanes):
                if b_prev is not None and b.frame == b_prev.frame + 1:
                    xy, ref = _lk_probe(setup, frames, p, b_prev, b, lane)
                    for side in sides:
                        tracked = reference.to_bf16(ref) if side == "control" else xy
                        got[side]["lk"][lane].append(np.linalg.norm(tracked - ref, axis=1))
                for side in sides:
                    v, n = _k1(setup, frames, b, lane, side)
                    got[side]["k1"][lane].append(v)
                    got[side]["nms"][lane].append(n)
            frames.drop(b.frame)
        for side in sides:
            pose = p.pose if side == "program" else np.stack(
                [reference.to_bf16(setup.gt[b][p.frames]) for b in range(lanes)], 1)
            nonfinite[side] += int((~np.isfinite(pose.reshape(pose.shape[:2] + (16,)))
                                    .all(-1)).sum())
            for lane in range(lanes):
                got[side]["seg"][lane].append(
                    segment_errors(pose[:, lane], setup.gt[lane][p.frames]))
    out = {}
    for side in sides:
        g = got[side]
        out[side] = {
            "nonfinite_poses": float(nonfinite[side]),
            "seg_err_med_m": _worst(g["seg"], np.median),
            "seg_err_p95_m": _worst(g["seg"], lambda e: np.percentile(e, 95)),
            "seg_err_max_m": _worst(g["seg"], np.max),
            "lk_gap_px": _worst(g["lk"], lambda d: np.percentile(d, LK_QUANTILE)),
            "lk_gap_med_px": _worst(g["lk"], np.median),
            "lk_gap_max_px": _worst(g["lk"], np.max),
            "lk_slots": float(sum(np.concatenate(v).size for v in g["lk"] if v)),
            "k1_gap": _worst(g["k1"], np.max),
            "k1_nms_gap": _worst(g["nms"], np.max),
            "k1_corners": float(sum(np.concatenate(v).size for v in g["k1"] if v)),
        }
    return out if control else out["program"]


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at or
    under its limit."""
    checks, ok = {}, True
    for name in NAMES:
        v, lim = values[name], float(limits[name])
        ok = ok and bool(np.isfinite(v)) and v <= lim
        # JSON has no NaN: a number that is not finite is written as null.
        checks[name] = {"value": float(v) if np.isfinite(v) else None, "limit": lim}
    return ok, checks
