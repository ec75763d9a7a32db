"""The VO pipeline: two-view bootstrap + the per-frame step — port of
vo_tpu/models/pipeline.py, all three tracker front-ends (klt: pyramidal LK;
harris, sift: frame-to-frame descriptor matching).

`vo_step(state, image, K, cfg) -> (state, out)` runs eagerly on the device
of its tensors. The reference's two `lax.cond`s (visual recovery when PnP
fails, keyframe push + BA) are branches on a device predicate here, and
everything else is static-shape masked tensor work, as in the reference.
The step is written as segments: `step_track` and `step_localize` (A:
tracking, then PnP), `step_recover` (R), `step_locate` (B1), `step_eigh`,
`step_map` (B2), `step_keyframe` (C), `step_finish` (D), and one schedule,
`run_step`, which takes the two predicates as device tensors and marks
every boundary between segments (`BOUNDARIES`). `vo_step` reads each
predicate on the host and skips a branch nobody takes; `vo_rollout` on a CUDA state replays the
whole step as ONE CUDA graph a frame, R and C as IF conditional nodes
decided on the device (models/graphed.py), the counterpart of the
reference's jit-compiled scan; elsewhere, or with `graph=False`, it is a
Python loop over `vo_step`.

Lanes: `vo_step` also takes a BATCHED state — every leaf with a leading lane
axis (B, ...), images (B, H, W), K (B, 3, 3) — and steps B independent
sequences in lockstep with the same tensor code (parallel/multiseq.py stacks
and rolls such states). Lane b of the result is what the unbatched step
gives on lane b. As under the reference's `vmap`, each host branch becomes a
select: the branch runs for all lanes when ANY lane takes it, and each
lane's own predicate picks its result.

Randomness: two streams, as the reference splits its key into `k_pnp` and
`k_rec` at every step. `bootstrap` takes a sampler (ops/ransac.py: a
torch.Generator, or a callable replaying indices drawn elsewhere) and keeps
it as `state.rng`: the bootstrap's RANSAC and every step's PnP draw from
it, one draw a step. The recovery's sampler is `state.rec_rng`, which PnP
never touches (by default a generator seeded from the PnP generator's seed,
`recovery_stream`). A recovery generator's uniforms are drawn on EVERY step,
whether or not a lane is lost (`recovery_samplers`), so the streams
advance alike in the eager step and in the captured one, where the draw
sits outside the graph and R inside a conditional node. A batched state
carries a sequence of B samplers of each kind, one per lane; a lane draws
from its own only, so lane b of a batch draws exactly what a single run of
that lane draws, whatever happens to its neighbours.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from vo_tpu_torch.geom.camera import Camera
from vo_tpu_torch.geom.lie import pose_inverse
from vo_tpu_torch.geom.points import bmat, device_vector, inverse, lift
from vo_tpu_torch.models.ba import (
    BAWindow,
    ba_refine_verdict,
    empty_window,
    push_keyframe,
    where_window,
)
from vo_tpu_torch.models.feature_table import (
    STATE_EMPTY,
    STATE_MATCHED,
    STATE_TRIANGULATED,
    STATE_UNMATCHED,
    FeatureTable,
    empty_table,
    fill_free_slots,
    restart_tracks,
)
from vo_tpu_torch.ops.epipolar import (
    RelativePose,
    essential_from_fundamental,
    fundamental_ransac,
    relative_pose_from_essential,
)
from vo_tpu_torch.ops.descriptors import extract_patches, match_descriptors
from vo_tpu_torch.ops.harris import detect_keypoints, refine_corners_subpixel
from vo_tpu_torch.ops.image import build_pyramid
from vo_tpu_torch.ops.klt import TrackResult, pyramidal_lk_counted
from vo_tpu_torch.ops.pnp import pnp_ransac
from vo_tpu_torch.ops.ransac import (
    Drawn,
    RansacResult,
    Samplers,
    draw_uniforms,
    drawn_hypotheses,
    is_lane_samplers,
    where_lane,
)
from vo_tpu_torch.ops.linalg import eigh_finite
from vo_tpu_torch.ops.triangulate import dlt_points, dlt_system, reprojection_error
from vo_tpu_torch.utils.config import VOConfig


class VOState(NamedTuple):
    table: FeatureTable
    """Shapes are those of one sequence; a batched state carries a leading
    lane axis (B, ...) on every tensor leaf and B samplers."""

    pose: torch.Tensor  # (4, 4) w_T_c of the current frame
    prev_pose: torch.Tensor  # (4, 4) w_T_c of the previous frame
    pyramid: tuple  # prev-frame Gaussian pyramid (tuple of tensors)
    frame_idx: torch.Tensor  # () int32
    next_uid: torch.Tensor  # () int32
    rng: Samplers  # RANSAC sampler (torch.Generator or replaying callable), or B of them
    rec_rng: Samplers  # the recovery's sampler (PnP never draws from it), or B of them
    window: BAWindow  # sliding keyframe window for on-device BA
    last_kf_idx: torch.Tensor  # () int32 frame index of the newest keyframe
    kf_adaptive: torch.Tensor  # () bool keyframe policy (False = fixed cadence)
    last_speed: torch.Tensor  # () f32 |t| of the last validated (pose_ok) step


class StepOutput(NamedTuple):
    pose: torch.Tensor  # (4, 4) w_T_c
    pose_ok: torch.Tensor  # () bool — PnP succeeded with enough inliers
    num_tracked: torch.Tensor
    num_triangulated: torch.Tensor
    num_candidates: torch.Tensor
    num_pnp_inliers: torch.Tensor
    num_new_landmarks: torch.Tensor
    frozen: torch.Tensor  # () bool — every pose tier was non-finite


def map_state(fn, *states: VOState, rng: Samplers, rec_rng: Samplers) -> VOState:
    """Apply fn to the corresponding tensor leaves of VOStates (table and
    window fields, pyramid levels, poses and scalars); the two samplers are
    set as given."""
    first = states[0]

    def leaf(get):
        return fn(*(get(s) for s in states))

    return VOState(
        table=FeatureTable(*(
            leaf(lambda s, i=i: s.table[i]) for i in range(len(first.table)))),
        window=BAWindow(*(
            leaf(lambda s, i=i: s.window[i]) for i in range(len(first.window)))),
        pyramid=tuple(
            leaf(lambda s, i=i: s.pyramid[i]) for i in range(len(first.pyramid))),
        rng=rng,
        rec_rng=rec_rng,
        **{
            name: leaf(lambda s, name=name: getattr(s, name))
            for name in ("pose", "prev_pose", "frame_idx", "next_uid",
                         "last_kf_idx", "kf_adaptive", "last_speed")
        },
    )


# A recovery generator's seed is its PnP generator's seed XOR this (odd,
# 64-bit) constant: distinct PnP seeds give distinct recovery seeds, and no
# draw of the PnP stream is spent on it.
_RECOVERY_SEED = 0x9E3779B97F4A7C15


def recovery_stream(rng: Samplers) -> Samplers:
    """The recovery's sampler(s) for PnP sampler(s) `rng` where the caller
    gives none: for each torch.Generator a new generator on its device,
    seeded from its seed (`_RECOVERY_SEED`). A replaying sampler has no such
    counterpart and gets None: the caller sets the recovery's own
    (`state._replace(rec_rng=...)`) before a step needs it."""
    if is_lane_samplers(rng):
        return [recovery_stream(r) for r in rng]
    if not isinstance(rng, torch.Generator):
        return None
    gen = torch.Generator(device=rng.device)
    return gen.manual_seed(rng.initial_seed() ^ _RECOVERY_SEED)


def recovery_shape(cfg: VOConfig) -> tuple[int, int]:
    """(hypotheses, points) of the recovery's uniforms: one row a hypothesis
    of R's RANSAC (ops/ransac.py `drawn_hypotheses`), one column a slot."""
    return drawn_hypotheses(cfg.recovery.num_hypotheses), cfg.capacity


def recovery_samplers(rec_rng: Samplers, cfg: VOConfig) -> list:
    """This step's recovery samplers, one a lane: a generator's uniforms are
    drawn NOW (`draw_uniforms`, whether or not R will run) and handed to R
    as `Drawn`; a replaying sampler is passed on as it is."""
    if any(r is None for r in rec_rng):
        raise ValueError("a lane has no recovery sampler (state.rec_rng is None): "
                         "`recovery_stream` gives none for a replaying PnP sampler")
    rows, cols = recovery_shape(cfg)
    return [Drawn(draw_uniforms(r, rows, cols)) if isinstance(r, torch.Generator) else r
            for r in rec_rng]


def generators(state: VOState) -> list:
    """Every torch.Generator the state's samplers hold: PnP's, then the
    recovery's, lane by lane."""
    found = []
    for samplers in (state.rng, state.rec_rng):
        lanes = samplers if is_lane_samplers(samplers) else [samplers]
        found += [g for g in lanes if isinstance(g, torch.Generator)]
    return found


def rewinder(state: VOState) -> Callable[[], None]:
    """A function that puts every generator of `state` back where it stands
    now, so that a second rollout from `state` makes the first one's draws."""
    saved = [(g, g.get_state()) for g in generators(state)]

    def rewind() -> None:
        for g, s in saved:
            g.set_state(s)

    return rewind


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

TRACKERS = ("klt", "harris", "sift")


def _check_tracker(cfg: VOConfig) -> None:
    if cfg.tracker not in TRACKERS:
        raise ValueError(f"unknown tracker {cfg.tracker!r}; have {TRACKERS}")


def _detect(image: torch.Tensor, cfg: VOConfig, num: int):
    d = cfg.detector
    harris = d.method == "harris" or cfg.tracker == "harris"
    return detect_keypoints(
        image, num, mode="harris" if harris else "shi_tomasi",
        patch_size=d.patch_size, kappa=d.kappa,
        nms_radius=d.harris_nms_radius if harris else d.nms_radius,
        border=d.border,
        quality_level=d.harris_quality_level if harris else d.quality_level,
        use_pallas=d.use_pallas,
    )


class Detections(NamedTuple):
    """Fixed-size per-frame detections with mode-specific descriptors; a
    leading lane axis on every field for images (B, H, W)."""

    xy: torch.Tensor  # (C, 2)
    score: torch.Tensor  # (C,)
    valid: torch.Tensor  # (C,)
    sigma: torch.Tensor  # (C,) detection scale (sift) or 0
    desc: torch.Tensor  # (C, D) descriptors (D=1 dummy for klt)


def _detect_mode(image: torch.Tensor, cfg: VOConfig) -> Detections:
    """Detect + describe with the configured front-end (ref tracker.py:43-63
    dispatch: klt->Shi-Tomasi, harris->Harris+patches, sift->DoG+SIFT)."""
    c = cfg.capacity
    if cfg.tracker == "sift":
        from vo_tpu_torch.ops.sift import build_scale_space, sift_describe, sift_detect

        s = cfg.sift
        # One scale space serves detection and description (the reference
        # builds it in both and leaves the sharing to the compiler).
        octaves = build_scale_space(image.to(torch.float32) / 255.0,
                                    s.num_octaves, s.scales_per_octave)
        kp = sift_detect(
            image, c, s.num_octaves, s.scales_per_octave,
            s.contrast_threshold, s.edge_ratio, border=cfg.detector.border,
            octaves=octaves,
        )
        desc = sift_describe(image, kp.xy, kp.sigma, s.num_octaves, s.scales_per_octave,
                             octaves=octaves)
        return Detections(kp.xy, kp.score, kp.valid, kp.sigma, desc)
    det = _detect(image, cfg, c)
    zeros = torch.zeros_like(det.score)
    if cfg.tracker == "harris":
        # Matched detections ARE the tracked positions in this mode, so
        # integer NMS grid positions would feed +-0.5 px quantization into
        # PnP at every frame (KLT gets subpixel from LK instead).
        xy = refine_corners_subpixel(image, det.xy, radius=4, iters=2)
        xy = torch.where(det.valid[..., None], xy, det.xy)
        desc = extract_patches(image, xy, cfg.descriptor.radius, normalize=True)
        return Detections(xy, det.score, det.valid, zeros, desc)
    return Detections(det.xy, det.score, det.valid, zeros, zeros[..., None])


def _mode_match_params(cfg: VOConfig) -> tuple[float, float]:
    if cfg.tracker == "sift":
        return cfg.sift.ratio, cfg.sift.max_move_px
    return cfg.descriptor.ratio, cfg.descriptor.max_move_px


def _match_track(
    slot_desc: torch.Tensor,  # (..., K, D) descriptors of live slots
    slot_xy: torch.Tensor,  # (..., K, 2) current slot positions
    slot_live: torch.Tensor,  # (..., K) bool
    det: Detections,
    ratio: float,
    max_move_px: float,
    move_scale: torch.Tensor | None = None,  # (..., K) per-slot gate multiplier
):
    """Frame-to-frame descriptor matching as a tracker (ref harris.py:50-84,
    sift.py:23-53 + the Matches identity carry-over, matches.py:113-212).

    Returns (TrackResult, match_idx (..., K), used (..., C) detections
    consumed). The spatial pre-gate (a detection within max_move_px of the
    slot, times `move_scale` for a slot that has coasted) is applied BEFORE
    the ratio test: on repetitive texture the global top-2 are lookalikes
    from elsewhere in the image and the ratio would kill true matches."""
    gate = max_move_px * (
        move_scale if move_scale is not None else torch.ones_like(slot_xy[..., 0]))
    gate2 = gate**2
    near = (
        ((slot_xy[..., :, None, :] - det.xy[..., None, :, :]) ** 2).sum(dim=-1)
        <= gate2[..., :, None]
    )
    m = match_descriptors(
        slot_desc, det.desc, valid1=slot_live, valid2=det.valid, ratio=ratio,
        pair_valid=near,
    )
    c = det.xy.shape[-2]
    safe = torch.clamp(m.idx, 0, c - 1)
    new_xy = torch.take_along_dim(det.xy, safe[..., None], dim=-2)
    move_ok = ((new_xy - slot_xy) ** 2).sum(dim=-1) <= gate2
    status = m.valid & move_ok
    # used[safe] |= status, duplicates and all: every write is the same
    # value (True), into a scratch column for the slots without a match, so
    # the result does not depend on the order the device applies them in.
    used = torch.zeros(det.valid.shape[:-1] + (c + 1,), dtype=torch.bool,
                       device=det.xy.device)
    used = used.scatter(-1, torch.where(status, safe, c), True)[..., :c]
    tr = TrackResult(
        xy=torch.where(status[..., None], new_xy, slot_xy),
        status=status,
        err=torch.where(status, m.dist, float("inf")),
    )
    return tr, safe, used


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., C, *tail) at idx (..., K) along the slot axis -> (..., K, *tail)."""
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (x.ndim - idx.ndim)),
                                dim=idx.ndim - 1)


def _camera(K: torch.Tensor, cfg: VOConfig) -> Camera:
    """The configured lens around K, in K's dtype (its coefficients written
    on K's device without a host copy)."""
    return Camera.create(K, dist=device_vector(cfg.dist, K.device, K.dtype), dtype=K.dtype)


def _undistort(xy: torch.Tensor, K: torch.Tensor, cfg: VOConfig) -> torch.Tensor:
    """Ideal-pinhole coordinates of raw observations (identity without
    distortion)."""
    if not any(cfg.dist):
        return xy
    return _camera(K, cfg).undistort_points(xy)


def _rays_world(pose: torch.Tensor, Kinv: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Unit bearing rays of pixels rotated into the world frame."""
    h = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    r_cam = (bmat(Kinv, h) @ h[..., None])[..., 0]
    r_w = (bmat(pose[..., :3, :3], r_cam) @ r_cam[..., None])[..., 0]
    return r_w / torch.clamp(torch.linalg.vector_norm(r_w, dim=-1, keepdim=True), min=1e-20)


def _proj_matrix(pose: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """P = K [R|t] with [R|t] = inv(pose), batched over leading dims (one
    pose per lane, or one per track of each lane)."""
    return lift(K, pose.ndim) @ pose_inverse(pose)[..., :3, :4]


def _lk(prev_pyr, next_pyr, xy, cfg: VOConfig, init_flow=None, count: bool = False):
    """(TrackResult, the point-iterations still active or None): see
    `pyramidal_lk_counted`."""
    k = cfg.klt
    return pyramidal_lk_counted(
        list(prev_pyr), list(next_pyr), xy,
        radius=k.radius, max_iters=k.max_iters, eps=k.eps, max_err=k.max_err,
        min_eig_threshold=k.min_eig_threshold, use_pallas=k.use_pallas,
        init_flow=init_flow, count=count,
    )


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Bootstrap (ref main.py:204-243)
# ---------------------------------------------------------------------------

class TwoView(NamedTuple):
    """What `two_view_f64` solves, in f64."""

    ransac: RansacResult  # F (..., 3, 3), its inliers and their count
    rel: RelativePose  # T_21 (unit baseline), points in frame 1, cheirality mask


def two_view_f64(xy0: torch.Tensor, xy1: torch.Tensor, valid: torch.Tensor,
                 K: torch.Tensor, cfg: VOConfig, stage, samplers: Samplers,
                 ideal1: bool = False) -> TwoView:
    """The relative pose of two views from their tracks, as the bootstrap
    and the recovery R solve it: the raw positions undistorted (`xy1` is
    already ideal with `ideal1`), the 8-point RANSAC with `stage`'s
    threshold and budget (cfg.bootstrap or cfg.recovery), E, and the
    cheirality vote that triangulates every slot.

    The one place of the port's f64 rule, a named deviation from the JAX
    package, whose two-view solve is f32: the tracks and K are cast to f64
    first, and everything after is f64. Each caller rounds what it keeps
    back to f32 and applies its own gates (`bootstrap_map`, `recover_pose`).
    Only the draw stays f32: the sample indices come from the f32 uniforms
    (`gumbel_top_k`), so the streams advance as before."""
    f64 = torch.float64
    xy0, xy1, K = (t.to(f64) for t in (xy0, xy1, K))
    xy0 = _undistort(xy0, K, cfg)
    if not ideal1:
        xy1 = _undistort(xy1, K, cfg)
    res = fundamental_ransac(
        samplers, xy0, xy1, valid=valid,
        inlier_threshold_px=stage.inlier_threshold_px,
        num_hypotheses=stage.num_hypotheses,
    )
    E = essential_from_fundamental(res.model, K, K)
    return TwoView(res, relative_pose_from_essential(E, xy0, xy1, K, K, weight=res.inliers))


def bootstrap_map(two: TwoView, cfg: VOConfig) -> tuple[torch.Tensor, torch.Tensor,
                                                        torch.Tensor]:
    """The bootstrap's map from its two-view solve: the pose of camera 1
    (w_T_c1, world = camera 0) and the landmarks in camera 0's frame,
    rounded to f32, and which slots hold a landmark (inliers in front of
    both cameras, inside the depth range, finite); the gates are taken in
    f64 before the rounding."""
    res, rp = two
    pose1 = pose_inverse(rp.T_21)
    depth1 = (rp.T_21[2, :3] @ rp.points1.T) + rp.T_21[2, 3]
    tcfg = cfg.triangulation
    good3d = (
        res.inliers
        & rp.good
        & (rp.points1[:, 2] > tcfg.min_depth)
        & (rp.points1[:, 2] < tcfg.max_depth)
        & (depth1 > tcfg.min_depth)
        & torch.isfinite(rp.points1).all(dim=1)
    )
    return pose1.to(torch.float32), rp.points1.to(torch.float32), good3d


def bootstrap(
    image0: torch.Tensor,
    image1: torch.Tensor,
    K: torch.Tensor,
    cfg: VOConfig,
    rng: Samplers,
) -> tuple[VOState, StepOutput]:
    """Initialize the map from two (non-adjacent) frames of ONE sequence.
    The world frame is camera 0; the bootstrap baseline is fixed to |t| = 1.
    The bootstrap's RANSAC draws from `rng`, which PnP goes on drawing from;
    the recovery's stream is `recovery_stream(rng)`.
    The lanes of a multi-sequence run are bootstrapped one by one and
    stacked (parallel/multiseq.py `stack_states`).

    A named deviation from the JAX package, whose bootstrap is f32: the
    two-view solve runs in f64 (`two_view_f64`, shared with the recovery R)
    and so do the pose of camera 1 and the landmark gates on it
    (`bootstrap_map`); the pose and the landmarks are rounded back to f32
    there, and the rest of the bootstrap (the table, the window,
    `last_speed`, the outputs) is f32 as before. In f32 the card's cuSOLVER
    and the CPU's LAPACK part by a few thousandths of a degree, and a
    depth test at its threshold then flips a landmark; in f64 both give
    the same flags. The draws are unchanged: one draw of (hypotheses,
    capacity) uniforms from `rng`, as in f32."""
    _check_tracker(cfg)
    dev = image0.device
    kcap = cfg.capacity
    kps = _detect_mode(image0, cfg)
    if cfg.tracker == "klt":
        pyr0 = build_pyramid(image0, cfg.klt.pyramid_levels)
        pyr1 = tuple(build_pyramid(image1, cfg.klt.pyramid_levels))
        tr, _ = _lk(pyr0, pyr1, kps.xy, cfg)
        desc1, sigma1 = kps.desc, kps.sigma
    else:
        pyr1 = (image1,)
        det1 = _detect_mode(image1, cfg)
        ratio, max_move = _mode_match_params(cfg)
        tr, midx, _ = _match_track(kps.desc, kps.xy, kps.valid, det1, ratio, max_move)
        desc1 = torch.where(tr.status[:, None], det1.desc[midx], kps.desc)
        sigma1 = torch.where(tr.status, det1.sigma[midx], kps.sigma)
    tracked = kps.valid & tr.status

    two = two_view_f64(kps.xy, tr.xy, tracked, K, cfg, cfg.bootstrap, rng)
    res = two.ransac
    pose1, points1, good3d = bootstrap_map(two, cfg)
    pose0 = torch.eye(4, dtype=torch.float32, device=dev)

    state = torch.where(
        good3d, STATE_TRIANGULATED, torch.where(tracked, STATE_MATCHED, STATE_EMPTY)
    ).to(torch.int32)
    table = empty_table(kcap, cfg.desc_dim, device=dev)._replace(
        xy=tr.xy,
        landmark=torch.where(good3d[:, None], points1, 0.0),
        state=state,
        track_xy=kps.xy,
        track_pose=pose0.reshape(1, 16).repeat(kcap, 1),
        uid=torch.arange(kcap, dtype=torch.int32, device=dev),
        score=kps.score,
        desc=desc1,
        sigma=sigma1,
    )
    window = push_keyframe(
        empty_window(cfg.ba.window, kcap, device=dev), pose1, table.xy,
        table.landmark, table.uid, table.state == STATE_TRIANGULATED,
    )
    gap = cfg.bootstrap.frame_gap
    vo_state = VOState(
        table=table,
        pose=pose1,
        prev_pose=pose0,
        pyramid=pyr1,
        frame_idx=_i32(gap, dev),
        next_uid=_i32(kcap, dev),
        rng=rng,
        rec_rng=recovery_stream(rng),
        window=window,
        last_kf_idx=_i32(gap, dev),
        kf_adaptive=torch.tensor(cfg.ba.keyframe_mode == "adaptive", device=dev),
        last_speed=torch.linalg.vector_norm(pose1[:3, 3]) / float(max(gap, 1)),
    )
    n3 = good3d.sum()
    out = StepOutput(
        pose=pose1,
        pose_ok=n3 >= cfg.bootstrap.min_inliers,
        num_tracked=tracked.sum(),
        num_triangulated=n3,
        num_candidates=(state == STATE_MATCHED).sum(),
        num_pnp_inliers=res.num_inliers,
        num_new_landmarks=n3,
        frozen=torch.tensor(False, device=dev),
    )
    return vo_state, out


# ---------------------------------------------------------------------------
# Per-frame step (ref main.py:248-327)
# ---------------------------------------------------------------------------

def vo_rollout(
    state: VOState, images: torch.Tensor, K: torch.Tensor, cfg: VOConfig,
    graph: bool = True, spans: bool = True,
) -> tuple[VOState, StepOutput]:
    """Run `vo_step` over a stacked (N, H, W) frame chunk; returns the final
    state and the per-frame StepOutputs stacked along a leading axis.

    On a CUDA state the step replays as one CUDA graph a frame, captured
    once per configuration and shape and kept for the process
    (models/graphed.py, utils/cache.py), with no host read between the
    first frame and the caller's fetch: the counterpart of the reference's
    jit-compiled `lax.scan`. The results are the eager loop's bit for bit; a
    capture or replay that fails raises. `graph=False` runs the eager loop
    (the counterpart of `jax.disable_jit`), as the CPU always does. The
    captured step carries its span marks and counters (models/spans.py)
    unless `spans=False`, a runner of its own. The caller's state is never
    written."""
    if graph and images.is_cuda:
        from vo_tpu_torch.models.graphed import graphed_rollout

        return graphed_rollout(state, images, K, cfg, spans=spans)
    outs = []
    for img in images:
        state, out = vo_step(state, img, K, cfg)
        outs.append(out)
    ROLLED["eager"] += len(outs)
    return state, StepOutput(*(torch.stack(f) for f in zip(*outs)))


# Frames that rollouts of this process ran, by what ran them: "graphs" (the
# captured step's replays, counted by the runner in models/graphed.py) or
# "eager" (the loop over `vo_step` above).
ROLLED = {"graphs": 0, "eager": 0}


def executor_since(before: dict) -> str:
    """What the rollouts since `before = dict(ROLLED)` ran: "graphs",
    "eager", "mixed" (both), or "none" (no frame). The name every JSON line
    of a rollout carries."""
    ran = [name for name, n in ROLLED.items() if n > before[name]]
    return ran[0] if len(ran) == 1 else "mixed" if ran else "none"


def _depth(T_cw: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame depth of points X (..., N, 3) under one world->camera
    transform per lane, T_cw (..., 4, 4)."""
    return (T_cw[..., None, 2, :3] * X).sum(-1) + T_cw[..., None, 2, 3]


def _mat_points(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(M @ X^T)^T for one 3x3 per lane against points (..., N, 3)."""
    return (M @ X.transpose(-1, -2)).transpose(-1, -2)


def vo_step(
    state: VOState, image: torch.Tensor, K: torch.Tensor, cfg: VOConfig
) -> tuple[VOState, StepOutput]:
    """One frame: the recovery's uniforms are drawn, then `run_step`'s
    schedule runs the segments eagerly, reading each branch's predicate on
    the host (`eager_branch`). The captured rollout runs the same schedule
    as one CUDA graph with the branches as conditional nodes."""
    _check_tracker(cfg)
    if not is_lane_samplers(state.rng):
        # One sequence is a batch of one lane: the same kernels and the same
        # reduction shapes as lane b of a larger batch, so a single run and
        # its lane in a batched run round alike.
        batch_of_one = map_state(lambda x: x[None], state, rng=[state.rng],
                                 rec_rng=[state.rec_rng])
        new, out = vo_step(batch_of_one, image[None], K.reshape(1, 3, 3), cfg)
        return (map_state(lambda x: x[0], new, rng=state.rng, rec_rng=state.rec_rng),
                StepOutput(*(f[0] for f in out)))
    if image.ndim != 3 or len(state.rng) != image.shape[0]:
        raise ValueError(
            f"a state of {len(state.rng)} lanes needs images (B, H, W), got "
            f"{tuple(image.shape)}")
    rec = recovery_samplers(state.rec_rng, cfg) if cfg.recovery.enabled else None
    eager = Segments(
        track=lambda: step_track(state, image, K, cfg),
        localize=lambda f: step_localize(state, f, K, cfg),
        recover=lambda a: a._replace(pose_fb=step_recover(state, a, K, cfg, rec)),
        locate=lambda a: step_locate(state, a, K, cfg),
        eigh=step_eigh,
        map=lambda a, g, vecs: step_map(state, a, g, vecs, image, cfg),
        keyframe=lambda a, b: step_keyframe(a, b, K, cfg),
        finish=lambda a, b: step_finish(state, a, b),
    )
    return run_step(eager, eager_branch, cfg)


class Segments(NamedTuple):
    """One frame's segments as callables over the results of the earlier
    ones: `vo_step` calls the step_* functions; the captured rollout
    (models/graphed.py) captures them into its graphs, where they write
    static buffers."""

    track: Callable[[], Any]  # A's front end -> Front
    localize: Callable[[Any], Any]  # A's PnP (f) -> Tracked
    recover: Callable[[Any], Any]  # R (a) -> Tracked, the lost lanes' fallback replaced
    locate: Callable[[Any], Any]  # B1 (a) -> Located
    eigh: Callable[[Any], Any]  # (g) -> the DLT's eigenvectors
    map: Callable[[Any, Any, Any], Any]  # B2 (a, g, vecs) -> Mapped
    keyframe: Callable[[Any, Any], Any]  # C (a, b) -> Mapped
    finish: Callable[[Any, Any], Any]  # D (a, b) -> the step's result


# branch(name, pred, run, skipped): run() where the device predicate `pred`
# (a bool tensor) holds, else `skipped`, the results as they stand.
Branch = Callable[[str, torch.Tensor, Callable[[], Any], Any], Any]

# The boundaries `run_step` marks, in step order: the frame's start; the
# ends of A's two parts; R's start and end, inside R's branch; the ends of
# B1, the eigh and B2; C's start and end, inside C's branch; the frame's end,
# after D.
BOUNDARIES = ("start", "track", "localize", "R.start", "R.end", "locate", "eigh", "map",
              "C.start", "C.end", "end")


def no_mark(boundary: str) -> None:
    """The eager step's mark: nothing."""


def _marked(mark: Callable[[str], None], name: str, run: Callable[[], Any]):
    """Branch `name`'s body: `run` between the branch's start and end marks."""
    def body():
        mark(f"{name}.start")
        out = run()
        mark(f"{name}.end")
        return out

    return body


def run_step(seg: Segments, branch: Branch, cfg: VOConfig,
             mark: Callable[[str], None] = no_mark):
    """The step's schedule, the one place it is written: A (the front end,
    then PnP); with the recovery on, R under "a lane lost its pose"; B1,
    eigh, B2; with BA on, C under "a lane pushes a keyframe"; D. Each
    predicate is a device tensor over the lanes, as the reference's
    `lax.cond`s take theirs; `branch` decides how it is taken
    (`eager_branch` reads it, the captured rollout makes it a conditional
    node). Inside a branch the work stays lane by lane: a lane keeps the
    branch's result only under its own predicate.

    `mark(boundary)` is called at every boundary of `BOUNDARIES`, between
    one segment's last work and the next one's first; a branch's start and
    end marks are part of the body that `branch` gets, so they run where
    the branch runs. A predicate and its branch's test count with the
    segment after the branch. Every segment enqueues its work on the one
    stream the step runs on, library calls included (a library that forks
    onto streams of its own joins them before its later work on that
    stream), so a mark follows all of the work before it: no segment needs
    a join before its end mark."""
    mark("start")
    f = seg.track()
    mark("track")
    a = seg.localize(f)
    mark("localize")
    if cfg.recovery.enabled:
        a = branch("R", (~a.pose_ok).any(), _marked(mark, "R", lambda: seg.recover(a)), a)
    g = seg.locate(a)
    mark("locate")
    vecs = seg.eigh(g)
    mark("eigh")
    b = seg.map(a, g, vecs)
    mark("map")
    if cfg.ba.enabled:
        b = branch("C", b.push.any(), _marked(mark, "C", lambda: seg.keyframe(a, b)), b)
    out = seg.finish(a, b)
    mark("end")
    return out


def eager_branch(name: str, pred: torch.Tensor, run: Callable[[], Any], skipped: Any):
    """The eager step's branch: one host read of the predicate, and the
    branch skipped where no lane takes it (which gives the bits of a
    conditional node that does not run)."""
    return run() if bool(pred) else skipped


class Front(NamedTuple):
    """The results of A's front end (`step_track`; every field with the lane
    axis)."""

    Kinv: torch.Tensor  # (B, 3, 3)
    table: FeatureTable  # after tracking: xy, state, miss (desc, sigma when matching)
    tracked: torch.Tensor  # (B, K) occupied and observed this frame: feeds geometry
    xy_u: torch.Tensor  # (B, K, 2) ideal-pinhole positions
    track_xy_u: torch.Tensor  # (B, K, 2) ideal-pinhole track starts
    rel_cv: torch.Tensor  # (B, 4, 4) last step's motion
    pyramid: tuple  # this frame's pyramid (klt) or (image,)
    det: Detections | None  # this frame's detections (harris, sift; klt: None)
    used: torch.Tensor | None  # (B, C) detections consumed by matching
    lk_active: torch.Tensor | None = None  # (B,) LK point-iterations still active, if counted


class Tracked(NamedTuple):
    """Segment A's results (every field with the lane axis)."""

    Kinv: torch.Tensor  # (B, 3, 3)
    table: FeatureTable  # after tracking: xy, state, miss (desc, sigma when matching)
    tracked: torch.Tensor  # (B, K) occupied and observed this frame: feeds geometry
    xy_u: torch.Tensor  # (B, K, 2) ideal-pinhole positions
    track_xy_u: torch.Tensor  # (B, K, 2) ideal-pinhole track starts
    tri: torch.Tensor  # (B, K) triangulated and observed: PnP's input
    pnp: Any  # PnPResult
    pose_ok: torch.Tensor  # (B,) PnP accepted
    pose_pnp: torch.Tensor  # (B, 4, 4) w_T_c from PnP
    pose_fb: torch.Tensor  # (B, 4, 4) fallback: constant velocity; R replaces lost lanes'
    pyramid: tuple  # this frame's pyramid (klt) or (image,)
    det: Detections | None  # this frame's detections (harris, sift; klt: None)
    used: torch.Tensor | None  # (B, C) detections consumed by matching


class Located(NamedTuple):
    """Segment B1's results: the frame's pose and the DLT systems of every
    slot, before the eigh."""

    table: FeatureTable  # after the outlier reset and the cheirality cull
    pose: torch.Tensor  # (B, 4, 4)
    pose_ok: torch.Tensor  # (B,)
    frozen: torch.Tensor  # (B,) every pose tier non-finite
    pose_flat: torch.Tensor  # (B, 16)
    T_cw: torch.Tensor  # (B, 4, 4)
    candidates: torch.Tensor  # (B, K) bearing-gated triangulation candidates
    P_start: torch.Tensor  # (B, K, 3, 4)
    P_now: torch.Tensor  # (B, 3, 4)
    system: torch.Tensor  # (B, K, 4, 4) A^T A of the DLT


class Mapped(NamedTuple):
    """Segment B2's results, which C rewrites on the lanes that push."""

    table: FeatureTable
    pose: torch.Tensor
    pose_ok: torch.Tensor
    frozen: torch.Tensor
    candidates: torch.Tensor
    good_new: torch.Tensor  # (B, K) newly triangulated
    next_uid: torch.Tensor  # (B,)
    window: BAWindow
    last_kf_idx: torch.Tensor  # (B,)
    push: torch.Tensor | None  # (B,) keyframe push (None without BA)
    new_frame_idx: torch.Tensor  # (B,)


def step_track(state: VOState, image: torch.Tensor, K: torch.Tensor,
               cfg: VOConfig, count: bool = False) -> Front:
    """Segment A's first part, the front end: the pyramid, tracking every
    occupied slot (LK or matching) and the table's update. With `count`,
    LK's point-iterations still active ride along (`Front.lk_active`)."""
    table = state.table
    Kinv = inverse(K)

    # ---- 1. Track every occupied slot with the configured front-end ----
    # klt: pyramidal LK; harris/sift: frame-to-frame descriptor matching.
    occupied = table.state >= STATE_UNMATCHED
    rel_cv = pose_inverse(state.prev_pose) @ state.pose  # last step's motion
    if cfg.tracker == "klt":
        pyr_new = tuple(build_pyramid(image, cfg.klt.pyramid_levels))
        init_flow = None
        if cfg.klt.predict_motion:
            # Seed LK with the constant-velocity prediction: rotation flow via
            # the infinite homography K R K^-1, full prediction for slots with a
            # landmark in front of the predicted camera.
            pose_pred = state.pose @ rel_cv
            T_pp = pose_inverse(pose_pred) @ state.pose  # prev cam -> pred cam
            xy_ideal = _undistort(table.xy, K, cfg)
            h = torch.cat([xy_ideal, torch.ones_like(table.xy[..., :1])], dim=-1)
            r = _mat_points(T_pp[..., :3, :3], _mat_points(Kinv, h))
            uv_rot = _mat_points(K, r)
            uv_rot = uv_rot[..., :2] / torch.where(
                uv_rot[..., 2:].abs() > 1e-6, uv_rot[..., 2:], 1.0)
            T_cp = pose_inverse(pose_pred)
            Xc = _mat_points(T_cp[..., :3, :3], table.landmark) + T_cp[..., None, :3, 3]
            uv_full = _mat_points(K, Xc)
            uv_full = uv_full[..., :2] / torch.where(Xc[..., 2:] > 0.2, Xc[..., 2:], 1.0)
            use_full = (table.state == STATE_TRIANGULATED) & (Xc[..., 2] > 0.2)
            guess = torch.where(use_full[..., None], uv_full, uv_rot)
            if any(cfg.dist):
                guess = _camera(K, cfg).distort_points(guess)
            init_flow = guess - table.xy
        tr, lk_active = _lk(state.pyramid, pyr_new, table.xy, cfg, init_flow, count)
        det = None
        used = None
    else:
        pyr_new = (image,)
        lk_active = None
        det = _detect_mode(image, cfg)
        ratio, max_move = _mode_match_params(cfg)
        tr, midx, used = _match_track(
            table.desc, table.xy, occupied, det, ratio, max_move,
            move_scale=(table.miss + 1).to(torch.float32),
        )
    # Miss grace period: a matched-detection slot survives up to max_miss
    # consecutive un-redetections instead of dying on the first; while it
    # coasts it is excluded from every geometric consumer below (its xy is
    # stale). KLT: max_miss = 0 (LK either tracks or the slot is gone).
    if cfg.tracker == "sift":
        max_miss = cfg.sift.max_miss
    elif cfg.tracker == "harris":
        max_miss = cfg.descriptor.max_miss
    else:
        max_miss = 0
    tracked = occupied & tr.status
    miss = torch.where(tracked, 0, table.miss + 1).to(torch.int32)
    coast = occupied & ~tr.status & (miss <= max_miss)
    st = torch.where(tracked | coast, table.state, STATE_EMPTY)
    st = torch.where(tracked & (st == STATE_UNMATCHED), STATE_MATCHED, st).to(torch.int32)
    table = table._replace(xy=tr.xy, state=st, miss=miss)
    # Only slots OBSERVED this frame feed geometry (PnP, candidates,
    # triangulation, keyframe obs); coasting slots carry identity only.
    fresh = tracked
    if det is not None:
        # Carry the latest matched descriptor/scale on each slot.
        table = table._replace(
            desc=torch.where(tracked[..., None], _gather_rows(det.desc, midx), table.desc),
            sigma=torch.where(tracked, _gather_rows(det.sigma, midx), table.sigma),
        )

    xy_u = _undistort(table.xy, K, cfg)
    track_xy_u = _undistort(table.track_xy, K, cfg)
    return Front(Kinv, table, fresh, xy_u, track_xy_u, rel_cv, pyr_new, det, used, lk_active)


def step_localize(state: VOState, f: Front, K: torch.Tensor, cfg: VOConfig) -> Tracked:
    """Segment A's second part: PnP on the triangulated slots and the
    constant-velocity fallback. Its one random draw is PnP's, from
    `state.rng`."""
    # ---- 2. P3P localization on triangulated slots ----
    table, xy_u = f.table, f.xy_u
    tri = (table.state == STATE_TRIANGULATED) & f.tracked
    pnp = pnp_ransac(
        state.rng, table.landmark, xy_u, K, valid=tri,
        inlier_threshold_px=cfg.pnp.inlier_threshold_px,
        num_hypotheses=cfg.pnp.num_hypotheses,
        refine_iters=cfg.pnp.refine_iters,
    )
    pose_ok = (pnp.num_inliers >= cfg.pnp.min_inliers) & _all_finite(pnp.T_cw)
    pose_pnp = pose_inverse(pnp.T_cw)
    # Fallback tier 1: constant velocity, translation pinned to the last
    # validated speed.
    t_cv = f.rel_cv[..., :3, 3]
    n_cv = torch.linalg.vector_norm(t_cv, dim=-1, keepdim=True)
    t_pin = t_cv * (state.last_speed[..., None] / torch.clamp(n_cv, min=1e-12))
    rel_pinned = f.rel_cv.clone()
    rel_pinned[..., :3, 3] = torch.where(n_cv > 1e-12, t_pin, t_cv)
    pose_cv = state.pose @ rel_pinned
    return Tracked(f.Kinv, table, f.tracked, xy_u, f.track_xy_u, tri, pnp, pose_ok, pose_pnp,
                   pose_cv, f.pyramid, f.det, f.used)


def step_recover(state: VOState, a: Tracked, K: torch.Tensor, cfg: VOConfig,
                 samplers: Samplers) -> torch.Tensor:
    """Segment R, run only when a lane lost its pose: fallback tier 2, the
    visual relative pose from this frame's 2D-2D tracks (8-point RANSAC ->
    E -> cheirality), scale pinned as the constant-velocity tier. It runs
    for all lanes, each on its own recovery sampler of this step
    (`recovery_samplers`); only a lost lane takes the result. Returns the
    new fallback pose."""
    return recover_pose(state.table.xy, a.xy_u, a.tracked, state.pose, state.last_speed,
                        a.pose_ok, a.pose_fb, K, cfg, samplers).pose_fb


class Recovered(NamedTuple):
    """What segment R computes, lane by lane."""

    pose_fb: torch.Tensor  # (B, 4, 4) the fallback pose: R's where `took`
    pose: torch.Tensor  # (B, 4, 4) R's pose, taken or not
    num_inliers: torch.Tensor  # (B,) inliers of the 8-point RANSAC's refit
    took: torch.Tensor  # (B,) the lane lost its pose and R's pose passed


def recover_pose(prev_xy: torch.Tensor, xy_u: torch.Tensor, tracked: torch.Tensor,
                 pose: torch.Tensor, last_speed: torch.Tensor, pose_ok: torch.Tensor,
                 pose_fb: torch.Tensor, K: torch.Tensor, cfg: VOConfig,
                 samplers: Samplers) -> Recovered:
    """`step_recover` over everything it reads: the last frame's positions
    (`state.table.xy`), this frame's ideal positions, the tracked slots, the
    last pose and speed (`state.pose`, `state.last_speed`), PnP's verdict
    and the constant-velocity fallback (`a.pose_ok`, `a.pose_fb`).

    A named deviation from the JAX package, whose R is f32: R runs in f64
    from its inputs (the undistortion included, `two_view_f64`) to its
    pose, which is rounded back to f32. At a turn the 8-point system is
    nearly degenerate, and two f32 eigensolvers (cuSOLVER on the card,
    LAPACK on the CPU) put different points on the inlier side; in f64 both
    agree to the system's condition number times 1e-16. The draws are
    unchanged: the sample indices come from the same f32 uniforms
    (`gumbel_top_k`)."""
    f64 = torch.float64
    res, rp = two_view_f64(prev_xy, xy_u, tracked, K, cfg, cfg.recovery, samplers,
                           ideal1=True)
    pose, last_speed = pose.to(f64), last_speed.to(f64)
    T21 = rp.T_21.clone()
    T21[..., :3, 3] = rp.T_21[..., :3, 3] * last_speed[..., None]
    pose_vis = (pose @ pose_inverse(T21)).to(pose_fb.dtype)
    ok = (res.num_inliers >= cfg.recovery.min_inliers) & _all_finite(pose_vis)
    took = ok & ~pose_ok
    return Recovered(where_lane(took, pose_vis, pose_fb), pose_vis, res.num_inliers, took)


def step_locate(state: VOState, a: Tracked, K: torch.Tensor, cfg: VOConfig) -> Located:
    """Segment B1: pose selection and the fail-safe, the outlier reset, the
    cheirality cull, the bearing gate, and the DLT systems of the slots."""
    tcfg = cfg.triangulation
    pose = where_lane(a.pose_ok, a.pose_pnp, a.pose_fb)
    # Last-resort fail-safe: hold the previous pose if every tier is
    # non-finite.
    pose_finite = _all_finite(pose)
    frozen = ~pose_finite
    pose = where_lane(pose_finite, pose, state.pose)
    pose_ok = a.pose_ok & pose_finite
    pose_flat = pose.reshape(pose.shape[:-2] + (16,))
    T_cw = pose_inverse(pose)

    # ---- 3. Outlier reset (state.py:162-172) ----
    table = restart_tracks(a.table, a.tri & ~a.pnp.inliers & pose_ok[..., None], pose_flat)

    # ---- 4. Cheirality cull of surviving landmarks (state.py:90-107) ----
    tri = table.state == STATE_TRIANGULATED
    z_now = _depth(T_cw, table.landmark)
    z_prev = _depth(pose_inverse(state.pose), table.landmark)
    behind = tri & ~((z_now > tcfg.min_depth) & (z_prev > tcfg.min_depth))
    table = restart_tracks(table, behind, pose_flat)

    # ---- 5. Bearing-angle candidate gate (state.py:135-160) ----
    cand_mask = (table.state == STATE_MATCHED) & a.tracked
    track_pose = table.track_pose.reshape(table.track_pose.shape[:-1] + (4, 4))
    ray_start = _rays_world(track_pose, a.Kinv, a.track_xy_u)
    ray_now = _rays_world(pose, a.Kinv, a.xy_u)
    angle = torch.arccos(torch.clamp((ray_start * ray_now).sum(-1), -1.0, 1.0))
    candidates = cand_mask & (angle >= tcfg.bearing_threshold)

    # ---- 6. Triangulate candidates (triangulation.py:38-86), up to the eigh ----
    P_start = _proj_matrix(track_pose, K)  # (..., K, 3, 4) per-track-start
    P_now = _proj_matrix(pose, K)  # (..., 3, 4)
    system = dlt_system(P_start, P_now, a.track_xy_u, a.xy_u)
    return Located(table, pose, pose_ok, frozen, pose_flat, T_cw, candidates,
                   P_start, P_now, system)


def step_eigh(g: Located) -> torch.Tensor:
    """Between B1 and B2: the DLT's eigenvectors (on the card cuSOLVER's
    XsyevBatched with its error flag left on the device, ops/cusolver.py)."""
    return eigh_finite(g.system)[1]


def step_map(state: VOState, a: Tracked, g: Located, vecs: torch.Tensor,
             image: torch.Tensor, cfg: VOConfig) -> Mapped:
    """Segment B2: the triangulated candidates, top-up detection into free
    slots, and the keyframe decision."""
    tcfg = cfg.triangulation
    X = dlt_points(vecs)
    track_pose = g.table.track_pose.reshape(g.table.track_pose.shape[:-1] + (4, 4))
    T_start = pose_inverse(track_pose)
    z_start = (T_start[..., 2, :3] * X).sum(-1) + T_start[..., 2, 3]
    z_new = _depth(g.T_cw, X)
    good_new = (
        g.candidates
        & torch.isfinite(X).all(-1)
        & (z_start > tcfg.min_depth)
        & (z_new > tcfg.min_depth)
        & (z_new < tcfg.max_depth)
        & (reprojection_error(g.P_now, X, a.xy_u) < tcfg.max_reproj_px)
        & (reprojection_error(g.P_start, X, a.track_xy_u) < tcfg.max_reproj_px)
    )
    table = g.table._replace(
        landmark=torch.where(good_new[..., None], X, g.table.landmark),
        state=torch.where(good_new, STATE_TRIANGULATED, g.table.state).to(torch.int32),
    )

    # ---- 7. Top-up detection into free slots (klt.py:98-116, 206-230) ----
    det = a.det
    if det is None:
        det = _detect_mode(image, cfg)
    live = table.state >= STATE_UNMATCHED
    d2 = ((det.xy[..., :, None, :] - table.xy[..., None, :, :]) ** 2).sum(dim=-1)
    d2 = torch.where(live[..., None, :], d2, float("inf"))
    far = d2.min(dim=-1).values > cfg.detector.min_dist_to_live**2
    det_ok = det.valid & far
    if a.used is not None:
        det_ok = det_ok & ~a.used
    table, next_uid = fill_free_slots(
        table, det.xy, det.score, det_ok, g.pose_flat, state.next_uid,
        det_desc=det.desc, det_sigma=det.sigma,
    )

    # ---- 8. Keyframe decision (the push and BA are segment C) ----
    new_frame_idx = (state.frame_idx + 1).to(torch.int32)
    window = state.window
    push = None
    if cfg.ba.enabled:
        # A fallback frame invalidates the window (its keyframes predate the
        # recovery): clear it; pushes resume on recovery.
        window = where_window(
            g.pose_ok, window, empty_window(cfg.ba.window, cfg.capacity, device=image.device)
        )
        want_kf = torch.where(
            state.kf_adaptive,
            _want_adaptive(window, table, g.pose, g.T_cw, new_frame_idx - state.last_kf_idx,
                           cfg),
            new_frame_idx % cfg.ba.keyframe_every == 0,
        )
        push = want_kf & g.pose_ok
    return Mapped(table, g.pose, g.pose_ok, g.frozen, g.candidates, good_new, next_uid,
                  window, state.last_kf_idx, push, new_frame_idx)


def step_keyframe(a: Tracked, b: Mapped, K: torch.Tensor, cfg: VOConfig,
                  verdict: bool = False):
    """Segment C, run only when a lane pushes: the keyframe push and the
    windowed BA. They run for all lanes when any lane pushes; each lane
    keeps them only under its own predicate. Returns the Mapped results or,
    with `verdict`, (Mapped, the lanes whose BA the accept veto kept, or
    None where BA is not part of the step)."""
    table = b.table
    pushed = push_keyframe(
        b.window, b.pose, a.xy_u, table.landmark, table.uid,
        (table.state == STATE_TRIANGULATED) & a.tracked,
    )
    landmark = table.landmark
    kept = None
    if cfg.ba.refine_in_step:
        pushed, _, kept = ba_refine_verdict(
            pushed, K, iters=cfg.ba.iters,
            damping=cfg.ba.damping, huber_px=cfg.ba.huber_px,
        )
        match = (
            (pushed.lm_uid == table.uid)
            & pushed.lm_valid
            & (table.state == STATE_TRIANGULATED)
            & b.push[..., None]
        )
        landmark = torch.where(match[..., None], pushed.landmark, table.landmark)
    kf_pose = pushed.kf_pose[..., -1, :].reshape(b.pose.shape)
    mapped = b._replace(
        table=table._replace(landmark=landmark),
        window=where_window(b.push, pushed, b.window),
        pose=where_lane(b.push, kf_pose, b.pose),
        last_kf_idx=torch.where(b.push, b.new_frame_idx, b.last_kf_idx),
    )
    return (mapped, kept) if verdict else mapped


def step_finish(state: VOState, a: Tracked, b: Mapped) -> tuple[VOState, StepOutput]:
    """Segment D: the validated speed, the new state and the StepOutput."""
    # Validated speed for the next step's fallback pinning.
    speed_now = torch.linalg.vector_norm(
        (pose_inverse(state.pose) @ b.pose)[..., :3, 3], dim=-1)
    last_speed = torch.where(b.pose_ok & torch.isfinite(speed_now), speed_now,
                             state.last_speed)
    new_state = VOState(
        table=b.table,
        pose=b.pose,
        prev_pose=state.pose,
        pyramid=a.pyramid,
        frame_idx=b.new_frame_idx,
        next_uid=b.next_uid,
        rng=state.rng,
        rec_rng=state.rec_rng,
        window=b.window,
        last_kf_idx=b.last_kf_idx,
        kf_adaptive=state.kf_adaptive,
        last_speed=last_speed,
    )
    out = StepOutput(
        pose=b.pose,
        pose_ok=b.pose_ok,
        num_tracked=a.tracked.sum(dim=-1),
        num_triangulated=(b.table.state == STATE_TRIANGULATED).sum(dim=-1),
        num_candidates=b.candidates.sum(dim=-1),
        num_pnp_inliers=a.pnp.num_inliers,
        num_new_landmarks=b.good_new.sum(dim=-1),
        frozen=b.frozen,
    )
    return new_state, out


def _all_finite(T: torch.Tensor) -> torch.Tensor:
    """Per-lane: every entry of the (..., 4, 4) matrix is finite."""
    return torch.isfinite(T).flatten(-2).all(dim=-1)


def _want_adaptive(window, table, pose, T_cw, gap, cfg: VOConfig) -> torch.Tensor:
    """Motion/covisibility-gated keyframe policy (cfg.ba.keyframe_mode ==
    "adaptive"): push when the baseline or rotation since the newest keyframe
    is significant or map overlap with it has decayed, within [min_gap,
    max_gap] frames — and never while stationary."""
    b = cfg.ba
    last_pose = window.kf_pose[..., -1, :].reshape(pose.shape)
    tri_f = table.state == STATE_TRIANGULATED
    n_tri = torch.clamp(tri_f.sum(dim=-1), min=1)
    z_tri = _depth(T_cw, table.landmark)
    mean_depth = torch.clamp(torch.where(tri_f, z_tri, 0.0).sum(dim=-1) / n_tri, min=1e-3)
    baseline = torch.linalg.vector_norm(pose[..., :3, 3] - last_pose[..., :3, 3], dim=-1)
    rel_rot = last_pose[..., :3, :3].transpose(-1, -2) @ pose[..., :3, :3]
    cos_r = 0.5 * (rel_rot.diagonal(dim1=-2, dim2=-1).sum(dim=-1) - 1.0)
    rot = torch.arccos(torch.clamp(cos_r, -1.0, 1.0))
    covis = (tri_f & window.obs_mask[..., -1]
             & (window.lm_uid == table.uid)).sum(dim=-1) / n_tri
    moving = baseline / mean_depth >= 0.25 * b.min_baseline_ratio
    want = (gap >= b.min_gap) & (
        (baseline / mean_depth >= b.min_baseline_ratio)
        | (rot >= b.min_rotation_rad)
        | (moving & (covis < b.min_covisibility))
        | (moving & (gap >= b.max_gap))
    )
    return want | ~window.kf_valid[..., -1]


# ---------------------------------------------------------------------------
# Carrying state between the JAX package and the port
# ---------------------------------------------------------------------------

def _fields(x) -> Mapping[str, Any]:
    return x._asdict() if hasattr(x, "_asdict") else x


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.bool_:
        return torch.as_tensor(arr.copy(), device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.as_tensor(arr.astype(np.int32), device=device)
    return torch.as_tensor(arr.astype(np.float32), device=device)


def state_from_numpy(state, device, rng: Samplers,
                     rec_rng: Samplers | None = None) -> VOState:
    """Build a VOState from arrays: a mapping (or NamedTuple, e.g. a JAX
    `VOState`) with VOState's field names whose `table`/`window` are
    mappings or NamedTuples of arrays and `pyramid` a sequence of arrays.
    Floats become f32, integers int32 (the numpy -> torch boundary). The
    JAX PRNG key has no counterpart: `rng` is the port's PnP sampler and
    `rec_rng` the recovery's (default `recovery_stream(rng)`). A batched
    state (every leaf with a leading B, as `jax.vmap` carries it) comes
    across the same way, with each a sequence of B samplers."""
    if rec_rng is None:
        rec_rng = recovery_stream(rng)
    if is_lane_samplers(rng):
        rng, rec_rng = list(rng), list(rec_rng)
        lanes = np.asarray(_fields(state)["frame_idx"]).shape
        if lanes != (len(rng),) or len(rec_rng) != len(rng):
            raise ValueError(f"{len(rng)} samplers and {len(rec_rng)} recovery samplers "
                             f"for a state with lane shape {lanes}")
    s = _fields(state)
    table = FeatureTable(**{k: _to_tensor(v, device) for k, v in _fields(s["table"]).items()})
    window = BAWindow(**{k: _to_tensor(v, device) for k, v in _fields(s["window"]).items()})
    scalars = {
        k: _to_tensor(s[k], device)
        for k in ("pose", "prev_pose", "frame_idx", "next_uid", "last_kf_idx",
                  "kf_adaptive", "last_speed")
    }
    return VOState(
        table=table,
        window=window,
        pyramid=tuple(_to_tensor(p, device) for p in s["pyramid"]),
        rng=rng,
        rec_rng=rec_rng,
        **scalars,
    )


def state_to_numpy(state: VOState) -> dict:
    """The inverse of `state_from_numpy`: nested dict of numpy arrays (the
    samplers are left out)."""
    def np_(t):
        return t.detach().cpu().numpy()

    out = {k: np_(v) for k, v in state._asdict().items()
           if k not in ("table", "window", "pyramid", "rng", "rec_rng")}
    out["table"] = {k: np_(v) for k, v in state.table._asdict().items()}
    out["window"] = {k: np_(v) for k, v in state.window._asdict().items()}
    out["pyramid"] = [np_(p) for p in state.pyramid]
    return out
