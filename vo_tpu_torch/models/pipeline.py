"""The VO pipeline: two-view bootstrap + the per-frame step — port of
vo_tpu/models/pipeline.py, all three tracker front-ends (klt: pyramidal LK;
harris, sift: frame-to-frame descriptor matching).

`vo_step(state, image, K, cfg) -> (state, out)` runs eagerly on the device
of its tensors. The reference's two `lax.cond`s (visual recovery when PnP
fails, keyframe push + BA) are host `if`s on a synchronized flag here;
everything else is static-shape masked tensor work, as in the reference.
`vo_rollout` is a Python loop over `vo_step` that stacks the StepOutputs.

Lanes: `vo_step` also takes a BATCHED state — every leaf with a leading lane
axis (B, ...), images (B, H, W), K (B, 3, 3) — and steps B independent
sequences in lockstep with the same tensor code (parallel/multiseq.py stacks
and rolls such states). Lane b of the result is what the unbatched step
gives on lane b. As under the reference's `vmap`, each host branch becomes a
select: the branch runs for all lanes when ANY lane takes it, and each
lane's own predicate picks its result.

Randomness: `bootstrap` takes a sampler (ops/ransac.py: a torch.Generator,
or a callable replaying indices drawn elsewhere) and keeps it as
`state.rng`; each RANSAC of a step draws from it in order (PnP, then the
E-matrix recovery when PnP failed). A batched state carries a sequence of B
samplers, one per lane. A lane draws from its own sampler only, and draws
for the recovery only on frames where its OWN PnP failed — so lane b of a
batch draws exactly what a single run of that lane draws, whatever happens
to its neighbours.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from vo_tpu_torch.geom.camera import Camera
from vo_tpu_torch.geom.lie import pose_inverse
from vo_tpu_torch.geom.points import bmat, lift
from vo_tpu_torch.models.ba import (
    BAWindow,
    ba_refine,
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
    essential_from_fundamental,
    fundamental_ransac,
    relative_pose_from_essential,
)
from vo_tpu_torch.ops.descriptors import extract_patches, match_descriptors
from vo_tpu_torch.ops.harris import detect_keypoints, refine_corners_subpixel
from vo_tpu_torch.ops.image import build_pyramid
from vo_tpu_torch.ops.klt import TrackResult, pyramidal_lk
from vo_tpu_torch.ops.pnp import pnp_ransac
from vo_tpu_torch.ops.ransac import IDLE, Samplers, is_lane_samplers, where_lane
from vo_tpu_torch.ops.triangulate import reprojection_error, triangulate_dlt
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


def map_state(fn, *states: VOState, rng: Samplers) -> VOState:
    """Apply fn to the corresponding tensor leaves of VOStates (table and
    window fields, pyramid levels, poses and scalars); `rng` is set as given."""
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
        **{
            name: leaf(lambda s, name=name: getattr(s, name))
            for name in ("pose", "prev_pose", "frame_idx", "next_uid",
                         "last_kf_idx", "kf_adaptive", "last_speed")
        },
    )


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


def _undistort(xy: torch.Tensor, K: torch.Tensor, cfg: VOConfig) -> torch.Tensor:
    """Ideal-pinhole coordinates of raw observations (identity without
    distortion)."""
    if not any(cfg.dist):
        return xy
    return Camera.create(K, dist=torch.tensor(cfg.dist, dtype=torch.float32,
                                              device=K.device)).undistort_points(xy)


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


def _lk(prev_pyr, next_pyr, xy, cfg: VOConfig, init_flow=None):
    k = cfg.klt
    return pyramidal_lk(
        list(prev_pyr), list(next_pyr), xy,
        radius=k.radius, max_iters=k.max_iters, eps=k.eps, max_err=k.max_err,
        min_eig_threshold=k.min_eig_threshold, use_pallas=k.use_pallas,
        init_flow=init_flow,
    )


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Bootstrap (ref main.py:204-243)
# ---------------------------------------------------------------------------

def bootstrap(
    image0: torch.Tensor,
    image1: torch.Tensor,
    K: torch.Tensor,
    cfg: VOConfig,
    rng: Samplers,
) -> tuple[VOState, StepOutput]:
    """Initialize the map from two (non-adjacent) frames of ONE sequence.
    The world frame is camera 0; the bootstrap baseline is fixed to |t| = 1.
    The lanes of a multi-sequence run are bootstrapped one by one and
    stacked (parallel/multiseq.py `stack_states`)."""
    _check_tracker(cfg)
    dev = image0.device
    kcap = cfg.capacity
    kps = _detect_mode(image0, cfg)
    if cfg.tracker == "klt":
        pyr0 = build_pyramid(image0, cfg.klt.pyramid_levels)
        pyr1 = tuple(build_pyramid(image1, cfg.klt.pyramid_levels))
        tr = _lk(pyr0, pyr1, kps.xy, cfg)
        desc1, sigma1 = kps.desc, kps.sigma
    else:
        pyr1 = (image1,)
        det1 = _detect_mode(image1, cfg)
        ratio, max_move = _mode_match_params(cfg)
        tr, midx, _ = _match_track(kps.desc, kps.xy, kps.valid, det1, ratio, max_move)
        desc1 = torch.where(tr.status[:, None], det1.desc[midx], kps.desc)
        sigma1 = torch.where(tr.status, det1.sigma[midx], kps.sigma)
    tracked = kps.valid & tr.status

    xy0_u = _undistort(kps.xy, K, cfg)
    xy1_u = _undistort(tr.xy, K, cfg)
    res = fundamental_ransac(
        rng, xy0_u, xy1_u, valid=tracked,
        inlier_threshold_px=cfg.bootstrap.inlier_threshold_px,
        num_hypotheses=cfg.bootstrap.num_hypotheses,
    )
    E = essential_from_fundamental(res.model, K, K)
    rp = relative_pose_from_essential(E, xy0_u, xy1_u, K, K, weight=res.inliers)

    pose0 = torch.eye(4, dtype=torch.float32, device=dev)
    pose1 = pose_inverse(rp.T_21)  # w_T_c1 (world = cam0)

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

    state = torch.where(
        good3d, STATE_TRIANGULATED, torch.where(tracked, STATE_MATCHED, STATE_EMPTY)
    ).to(torch.int32)
    table = empty_table(kcap, cfg.desc_dim, device=dev)._replace(
        xy=tr.xy,
        landmark=torch.where(good3d[:, None], rp.points1, 0.0),
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
    state: VOState, images: torch.Tensor, K: torch.Tensor, cfg: VOConfig
) -> tuple[VOState, StepOutput]:
    """Run `vo_step` over a stacked (N, H, W) frame chunk; returns the final
    state and the per-frame StepOutputs stacked along a leading axis."""
    outs = []
    for img in images:
        state, out = vo_step(state, img, K, cfg)
        outs.append(out)
    return state, StepOutput(*(torch.stack(f) for f in zip(*outs)))


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
    _check_tracker(cfg)
    if not is_lane_samplers(state.rng):
        # One sequence is a batch of one lane: the same kernels and the same
        # reduction shapes as lane b of a larger batch, so a single run and
        # its lane in a batched run round alike.
        batch_of_one = map_state(lambda x: x[None], state, rng=[state.rng])
        new, out = vo_step(batch_of_one, image[None], K.reshape(1, 3, 3), cfg)
        return (map_state(lambda x: x[0], new, rng=state.rng),
                StepOutput(*(f[0] for f in out)))
    if image.ndim != 3 or len(state.rng) != image.shape[0]:
        raise ValueError(
            f"a state of {len(state.rng)} lanes needs images (B, H, W), got "
            f"{tuple(image.shape)}")
    tcfg = cfg.triangulation
    table = state.table
    Kinv = torch.linalg.inv(K)

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
                cam = Camera.create(K, dist=torch.tensor(cfg.dist, dtype=torch.float32,
                                                         device=K.device))
                guess = cam.distort_points(guess)
            init_flow = guess - table.xy
        tr = _lk(state.pyramid, pyr_new, table.xy, cfg, init_flow)
        det = None
        used = None
    else:
        pyr_new = (image,)
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

    # ---- 2. P3P localization on triangulated slots ----
    tri = (table.state == STATE_TRIANGULATED) & fresh
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
    t_cv = rel_cv[..., :3, 3]
    n_cv = torch.linalg.vector_norm(t_cv, dim=-1, keepdim=True)
    t_pin = t_cv * (state.last_speed[..., None] / torch.clamp(n_cv, min=1e-12))
    rel_pinned = rel_cv.clone()
    rel_pinned[..., :3, 3] = torch.where(n_cv > 1e-12, t_pin, t_cv)
    pose_cv = state.pose @ rel_pinned
    pose_fb = pose_cv
    lost = (~pose_ok).reshape(-1).tolist() if cfg.recovery.enabled else [False]
    if any(lost):
        # Fallback tier 2: visual relative pose from this frame's 2D-2D
        # tracks (8-point RANSAC -> E -> cheirality), scale pinned as above.
        # It runs for all lanes when any lane lost its pose; only a lost
        # lane draws from its sampler and only a lost lane takes the result.
        rng = [r if lost_b else IDLE for r, lost_b in zip(state.rng, lost)]
        prev_xy_u = _undistort(state.table.xy, K, cfg)
        res = fundamental_ransac(
            rng, prev_xy_u, xy_u, valid=tracked,
            inlier_threshold_px=cfg.recovery.inlier_threshold_px,
            num_hypotheses=cfg.recovery.num_hypotheses,
        )
        E = essential_from_fundamental(res.model, K, K)
        rp = relative_pose_from_essential(E, prev_xy_u, xy_u, K, K, weight=res.inliers)
        T21 = rp.T_21.clone()
        T21[..., :3, 3] = rp.T_21[..., :3, 3] * state.last_speed[..., None]
        pose_vis = state.pose @ pose_inverse(T21)
        ok = (res.num_inliers >= cfg.recovery.min_inliers) & _all_finite(pose_vis)
        pose_fb = where_lane(ok & ~pose_ok, pose_vis, pose_cv)
    pose = where_lane(pose_ok, pose_pnp, pose_fb)
    # Last-resort fail-safe: hold the previous pose if every tier is
    # non-finite.
    pose_finite = _all_finite(pose)
    frozen = ~pose_finite
    pose = where_lane(pose_finite, pose, state.pose)
    pose_ok = pose_ok & pose_finite
    pose_flat = pose.reshape(pose.shape[:-2] + (16,))
    T_cw = pose_inverse(pose)

    # ---- 3. Outlier reset (state.py:162-172) ----
    table = restart_tracks(table, tri & ~pnp.inliers & pose_ok[..., None], pose_flat)

    # ---- 4. Cheirality cull of surviving landmarks (state.py:90-107) ----
    tri = table.state == STATE_TRIANGULATED
    z_now = _depth(T_cw, table.landmark)
    z_prev = _depth(pose_inverse(state.pose), table.landmark)
    behind = tri & ~((z_now > tcfg.min_depth) & (z_prev > tcfg.min_depth))
    table = restart_tracks(table, behind, pose_flat)

    # ---- 5. Bearing-angle candidate gate (state.py:135-160) ----
    cand_mask = (table.state == STATE_MATCHED) & fresh
    track_pose = table.track_pose.reshape(table.track_pose.shape[:-1] + (4, 4))
    ray_start = _rays_world(track_pose, Kinv, track_xy_u)
    ray_now = _rays_world(pose, Kinv, xy_u)
    angle = torch.arccos(torch.clamp((ray_start * ray_now).sum(-1), -1.0, 1.0))
    candidates = cand_mask & (angle >= tcfg.bearing_threshold)

    # ---- 6. Triangulate candidates (triangulation.py:38-86) ----
    P_start = _proj_matrix(track_pose, K)  # (..., K, 3, 4) per-track-start
    P_now = _proj_matrix(pose, K)  # (..., 3, 4)
    X = triangulate_dlt(P_start, P_now, track_xy_u, xy_u)
    T_start = pose_inverse(track_pose)
    z_start = (T_start[..., 2, :3] * X).sum(-1) + T_start[..., 2, 3]
    z_new = _depth(T_cw, X)
    good_new = (
        candidates
        & torch.isfinite(X).all(-1)
        & (z_start > tcfg.min_depth)
        & (z_new > tcfg.min_depth)
        & (z_new < tcfg.max_depth)
        & (reprojection_error(P_now, X, xy_u) < tcfg.max_reproj_px)
        & (reprojection_error(P_start, X, track_xy_u) < tcfg.max_reproj_px)
    )
    table = table._replace(
        landmark=torch.where(good_new[..., None], X, table.landmark),
        state=torch.where(good_new, STATE_TRIANGULATED, table.state).to(torch.int32),
    )

    # ---- 7. Top-up detection into free slots (klt.py:98-116, 206-230) ----
    if det is None:
        det = _detect_mode(image, cfg)
    live = table.state >= STATE_UNMATCHED
    d2 = ((det.xy[..., :, None, :] - table.xy[..., None, :, :]) ** 2).sum(dim=-1)
    d2 = torch.where(live[..., None, :], d2, float("inf"))
    far = d2.min(dim=-1).values > cfg.detector.min_dist_to_live**2
    det_ok = det.valid & far
    if used is not None:
        det_ok = det_ok & ~used
    table, next_uid = fill_free_slots(
        table, det.xy, det.score, det_ok, pose_flat, state.next_uid,
        det_desc=det.desc, det_sigma=det.sigma,
    )

    # ---- 8. Keyframe push + windowed BA ----
    new_frame_idx = (state.frame_idx + 1).to(torch.int32)
    window = state.window
    last_kf_idx = state.last_kf_idx
    if cfg.ba.enabled:
        # A fallback frame invalidates the window (its keyframes predate the
        # recovery): clear it; pushes resume on recovery.
        window = where_window(
            pose_ok, window, empty_window(cfg.ba.window, cfg.capacity, device=K.device)
        )
        want_kf = torch.where(
            state.kf_adaptive,
            _want_adaptive(window, table, pose, T_cw, new_frame_idx - state.last_kf_idx, cfg),
            new_frame_idx % cfg.ba.keyframe_every == 0,
        )
        push = want_kf & pose_ok
        if bool(push.any()):
            # The push (and BA) runs for all lanes when any lane pushes;
            # each lane keeps it only under its own predicate.
            pushed = push_keyframe(
                window, pose, xy_u, table.landmark, table.uid,
                (table.state == STATE_TRIANGULATED) & fresh,
            )
            landmark = table.landmark
            if cfg.ba.refine_in_step:
                pushed, _ = ba_refine(
                    pushed, K, iters=cfg.ba.iters,
                    damping=cfg.ba.damping, huber_px=cfg.ba.huber_px,
                )
                match = (
                    (pushed.lm_uid == table.uid)
                    & pushed.lm_valid
                    & (table.state == STATE_TRIANGULATED)
                    & push[..., None]
                )
                landmark = torch.where(match[..., None], pushed.landmark, table.landmark)
            table = table._replace(landmark=landmark)
            window = where_window(push, pushed, window)
            kf_pose = pushed.kf_pose[..., -1, :].reshape(pose.shape)
            pose = where_lane(push, kf_pose, pose)
            last_kf_idx = torch.where(push, new_frame_idx, last_kf_idx)

    # Validated speed for the next step's fallback pinning.
    speed_now = torch.linalg.vector_norm(
        (pose_inverse(state.pose) @ pose)[..., :3, 3], dim=-1)
    last_speed = torch.where(pose_ok & torch.isfinite(speed_now), speed_now, state.last_speed)

    new_state = VOState(
        table=table,
        pose=pose,
        prev_pose=state.pose,
        pyramid=pyr_new,
        frame_idx=new_frame_idx,
        next_uid=next_uid,
        rng=state.rng,
        window=window,
        last_kf_idx=last_kf_idx,
        kf_adaptive=state.kf_adaptive,
        last_speed=last_speed,
    )
    out = StepOutput(
        pose=pose,
        pose_ok=pose_ok,
        num_tracked=tracked.sum(dim=-1),
        num_triangulated=(table.state == STATE_TRIANGULATED).sum(dim=-1),
        num_candidates=candidates.sum(dim=-1),
        num_pnp_inliers=pnp.num_inliers,
        num_new_landmarks=good_new.sum(dim=-1),
        frozen=frozen,
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


def state_from_numpy(state, device, rng: Samplers) -> VOState:
    """Build a VOState from arrays: a mapping (or NamedTuple, e.g. a JAX
    `VOState`) with VOState's field names whose `table`/`window` are
    mappings or NamedTuples of arrays and `pyramid` a sequence of arrays.
    Floats become f32, integers int32 (the numpy -> torch boundary). The
    JAX PRNG key has no counterpart: `rng` is the port's sampler. A batched
    state (every leaf with a leading B, as `jax.vmap` carries it) comes
    across the same way, with `rng` a sequence of B samplers."""
    if is_lane_samplers(rng):
        rng = list(rng)
        lanes = np.asarray(_fields(state)["frame_idx"]).shape
        if lanes != (len(rng),):
            raise ValueError(f"{len(rng)} samplers for a state with lane shape {lanes}")
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
        **scalars,
    )


def state_to_numpy(state: VOState) -> dict:
    """The inverse of `state_from_numpy`: nested dict of numpy arrays (the
    sampler is left out)."""
    def np_(t):
        return t.detach().cpu().numpy()

    out = {k: np_(v) for k, v in state._asdict().items()
           if k not in ("table", "window", "pyramid", "rng")}
    out["table"] = {k: np_(v) for k, v in state.table._asdict().items()}
    out["window"] = {k: np_(v) for k, v in state.window._asdict().items()}
    out["pyramid"] = [np_(p) for p in state.pyramid]
    return out
