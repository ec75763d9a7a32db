"""Sliding-window bundle adjustment: batched Schur-complement Gauss-Newton —
port of vo_tpu/models/ba.py, with its `reduce_fn` hook for landmark-sharded
BA (parallel/dist_ba.py).

  * fixed window of W keyframes and L landmark rows (L = table capacity);
  * all (L, W) reprojection residuals and analytic Jacobians in one sweep;
  * landmark blocks eliminated with closed-form 3x3 inverses, the reduced
    camera system (W, W, 6, 6) solved by hand-written block Cholesky;
  * fixed iteration count, Levenberg damping, gauge frozen at the oldest
    keyframe, similarity renormalization of the scale, and an accept veto.

Pose convention: window poses are w_T_c; increments are left-multiplied
se(3) twists on c_T_w.

Every field of a window may carry a leading lane axis (B, ...) with K
(B, 3, 3): each lane is then its own window — its own gauge keyframe, scale
renormalization and accept veto.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from vo_tpu_torch.geom.lie import pose_inverse, se3_exp
from vo_tpu_torch.ops.linalg import spd_solve_blocked
from vo_tpu_torch.ops.ransac import lane_by_lane, pick, where_lane

# Gauge fixing: diagonal added to the first keyframe's camera block.
_GAUGE = 1e8


class BAWindow(NamedTuple):
    kf_pose: torch.Tensor  # (W, 16) w_T_c per keyframe
    kf_valid: torch.Tensor  # (W,) bool
    obs_uv: torch.Tensor  # (L, W, 2) pixel observations
    obs_mask: torch.Tensor  # (L, W) bool
    landmark: torch.Tensor  # (L, 3) world points (current estimate)
    lm_uid: torch.Tensor  # (L,) int32 slot uid the row belongs to
    lm_valid: torch.Tensor  # (L,) bool

    @property
    def window_size(self) -> int:
        return self.kf_pose.shape[-2]


def empty_window(num_keyframes: int, capacity: int, device=None) -> BAWindow:
    eye = torch.eye(4, dtype=torch.float32, device=device).reshape(1, 16)
    return BAWindow(
        kf_pose=eye.repeat(num_keyframes, 1),
        kf_valid=torch.zeros((num_keyframes,), dtype=torch.bool, device=device),
        obs_uv=torch.zeros((capacity, num_keyframes, 2), dtype=torch.float32, device=device),
        obs_mask=torch.zeros((capacity, num_keyframes), dtype=torch.bool, device=device),
        landmark=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        lm_uid=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        lm_valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def where_window(cond: torch.Tensor, a: BAWindow, b: BAWindow) -> BAWindow:
    """Field-wise torch.where(cond, a, b) for a scalar condition, or one
    condition per lane (B,) against windows with a lane axis (`b` may be an
    unbatched window shared by all lanes)."""
    return BAWindow(*(where_lane(cond, x, y) for x, y in zip(a, b)))


def push_keyframe(
    window: BAWindow,
    pose: torch.Tensor,  # (..., 4, 4) w_T_c of the new keyframe
    slot_xy: torch.Tensor,  # (..., L, 2)
    slot_landmark: torch.Tensor,  # (..., L, 3)
    slot_uid: torch.Tensor,  # (..., L) int32
    slot_triangulated: torch.Tensor,  # (..., L) bool
) -> BAWindow:
    """Shift the window left and append the current frame as the newest
    keyframe; observations of recycled slots (uid changed) are dropped."""
    same = window.lm_uid == slot_uid
    tri = slot_triangulated[..., None]
    obs_uv = torch.where(same[..., None, None], window.obs_uv, 0.0)
    obs_mask = window.obs_mask & same[..., None]
    kf_pose = torch.cat(
        [window.kf_pose[..., 1:, :], pose.reshape(pose.shape[:-2] + (1, 16))], dim=-2)
    kf_valid = torch.cat(
        [window.kf_valid[..., 1:], torch.ones_like(window.kf_valid[..., :1])], dim=-1)
    obs_uv = torch.cat(
        [obs_uv[..., 1:, :], torch.where(tri, slot_xy, 0.0)[..., None, :]], dim=-2)
    obs_mask = torch.cat([obs_mask[..., 1:], tri], dim=-1)
    return BAWindow(
        kf_pose=kf_pose,
        kf_valid=kf_valid,
        obs_uv=obs_uv,
        obs_mask=obs_mask,
        landmark=torch.where(tri, slot_landmark, window.landmark),
        lm_uid=slot_uid,
        lm_valid=slot_triangulated & (obs_mask.sum(dim=-1) >= 2),
    )


def _residuals_jacobians(kf_pose_flat, landmark, obs_uv, K):
    """r (..., L, W, 2), Jc (..., L, W, 2, 6), Jx (..., L, W, 2, 3),
    depth_ok (..., L, W)."""
    T_cw = pose_inverse(kf_pose_flat.reshape(kf_pose_flat.shape[:-1] + (4, 4)))
    R = T_cw[..., :3, :3]  # (..., W, 3, 3)
    t = T_cw[..., :3, 3]
    xc = torch.einsum("...wij,...lj->...lwi", R, landmark) + t[..., None, :, :]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    depth_ok = z > 1e-3
    zs = torch.where(depth_ok, z, 1.0)
    fx, fy, cx, cy = (K[..., i, j, None, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    u = fx * x / zs + cx
    v = fy * y / zs + cy
    r = torch.stack([u, v], dim=-1) - obs_uv

    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    Jpi = torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
            torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        ],
        dim=-2,
    )
    hat = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )  # [x_c]x
    Jc = torch.cat([Jpi, -Jpi @ hat], dim=-1)
    Jx = torch.einsum("...lwij,...wjk->...lwik", Jpi, R)
    return r, Jc, Jx, depth_ok


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _obs_mask(window: BAWindow, depth_ok: torch.Tensor) -> torch.Tensor:
    return (window.obs_mask & depth_ok & window.lm_valid[..., :, None]
            & window.kf_valid[..., None, :])


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _gn_step(window: BAWindow, K: torch.Tensor, damping: float, huber_px: float,
             reduce_fn=_same, solve=spd_solve_blocked):
    """One damped Schur-complement GN step. Returns (new kf_pose, new
    landmark, mean masked reprojection error before the step).

    `solve(S, b)` solves the (..., W, W, 6, 6) camera system; the blocked
    Cholesky is the step's, tools/bench_solvers_torch.py times a dense LU
    against it.

    `reduce_fn` sums landmark-partitioned terms over the ranks that hold the
    other landmark rows (parallel/dist_ba.py): the camera-side normal
    equations (U, bc, the Schur fill-in and its gradient term) and the error
    ride the collective, the landmark elimination stays local. It sums over
    ranks, never over the lane axis."""
    W = window.window_size
    dev = K.device
    r, Jc, Jx, depth_ok = _residuals_jacobians(
        window.kf_pose, window.landmark, window.obs_uv, K
    )
    mask = _obs_mask(window, depth_ok)
    rn = torch.linalg.vector_norm(r, dim=-1)
    wgt = torch.where(rn > huber_px, huber_px / torch.clamp(rn, min=1e-9), 1.0)
    m = (mask * wgt)[..., None, None]
    err = _masked_mean(rn, mask, reduce_fn)

    # A lane must round as its single run: where an einsum was seen to pick
    # its kernel by the batch shape, it runs lane by lane (bc, the
    # back-substitution) or is written as products and sums (b_red).
    Jc_m = Jc * m
    U = reduce_fn(torch.einsum("...lwia,...lwib->...wab", Jc_m, Jc))  # (..., W, 6, 6)
    bc = reduce_fn(lane_by_lane(partial(torch.einsum, "...lwia,...lwi->...wa"),
                                Jc_m, r, core=4))  # (..., W, 6)
    Jx_m = Jx * m
    V = torch.einsum("...lwia,...lwib->...lab", Jx_m, Jx)  # (..., L, 3, 3)
    bx = torch.einsum("...lwia,...lwi->...la", Jx_m, r)  # (..., L, 3)
    Wc = torch.einsum("...lwia,...lwib->...lwab", Jc_m, Jx)  # (..., L, W, 6, 3)

    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    V = V + damping * eye3
    Vinv = _inv3(V) * window.lm_valid[..., None, None]

    # Schur complement S = U - sum_l Wc V^-1 Wc^T  (..., W, W, 6, 6).
    WVi = torch.einsum("...lwab,...lbc->...lwac", Wc, Vinv)
    S = -reduce_fn(torch.einsum("...lwac,...lvbc->...wvab", WVi, Wc))
    diag = torch.arange(W, device=dev)
    S[..., diag, diag, :, :] += U + damping * eye6
    b_red = bc - reduce_fn((WVi * bx[..., :, None, None, :]).sum(dim=-1).sum(dim=-3))

    # Gauge: freeze the oldest valid keyframe (each lane's own); dead
    # keyframes get identity blocks so the solve stays well-posed.
    first = torch.argmax(window.kf_valid.to(torch.int32), dim=-1, keepdim=True)
    is_first = diag == first  # (..., W)
    S[..., diag, diag, :, :] += is_first[..., None, None] * _GAUGE * eye6
    dead = ~window.kf_valid
    S[..., diag, diag, :, :] += dead[..., None, None] * _GAUGE * eye6

    delta_c = solve(S, -b_red)
    # A degenerate window (floored Cholesky pivot) yields a no-op step.
    solve_ok = torch.isfinite(delta_c).flatten(-2).all(dim=-1)[..., None, None]
    delta_c = torch.where(solve_ok, delta_c, 0.0)
    rhs = -bx - (Wc * delta_c[..., None, :, :, None]).sum(dim=(-3, -2))
    delta_x = lane_by_lane(partial(torch.einsum, "...lab,...lb->...la"), Vinv, rhs, core=3)
    delta_x = torch.where(
        solve_ok & torch.isfinite(delta_x).all(dim=-1, keepdim=True), delta_x, 0.0
    )

    delta_c = torch.where(window.kf_valid[..., None], delta_c, 0.0)
    T_cw = pose_inverse(window.kf_pose.reshape(window.kf_pose.shape[:-1] + (4, 4)))
    kf_pose = pose_inverse(se3_exp(delta_c) @ T_cw).reshape(window.kf_pose.shape)
    landmark = window.landmark + torch.where(window.lm_valid[..., None], delta_x, 0.0)
    return kf_pose, landmark, err


def _masked_mean(rn: torch.Tensor, mask: torch.Tensor, reduce_fn=_same) -> torch.Tensor:
    """Mean of rn (..., L, W) over the masked observations of each window;
    numerator and count are summed by `reduce_fn` before the division."""
    total = reduce_fn(torch.where(mask, rn, 0.0).sum(dim=(-2, -1)))
    return total / torch.clamp(reduce_fn(mask.sum(dim=(-2, -1))), min=1)


def _mean_reproj_err(window: BAWindow, K: torch.Tensor, reduce_fn=_same) -> torch.Tensor:
    """Masked mean reprojection error of the window."""
    r, _, _, depth_ok = _residuals_jacobians(
        window.kf_pose, window.landmark, window.obs_uv, K
    )
    mask = _obs_mask(window, depth_ok)
    return _masked_mean(torch.linalg.vector_norm(r, dim=-1), mask, reduce_fn)


def _two_oldest_valid(kf_valid: torch.Tensor):
    idx = torch.arange(kf_valid.shape[-1], device=kf_valid.device)
    first = torch.argmax(kf_valid.to(torch.int32), dim=-1)
    second = torch.argmax((kf_valid & (idx > first[..., None])).to(torch.int32), dim=-1)
    has2 = (kf_valid.sum(dim=-1) >= 2) & (second > first)
    return first, second, has2


def ba_refine(
    window: BAWindow,
    K: torch.Tensor,
    iters: int = 5,
    damping: float = 1e-3,
    huber_px: float = 2.0,
    reduce_fn=None,
    fix_scale: bool = True,
) -> tuple[BAWindow, torch.Tensor]:
    """Run `iters` damped GN steps. Returns (refined window, (..., iters)
    mean reprojection error trace — err[i] is BEFORE step i).

    With `fix_scale` the window is similarity-renormalized so the baseline
    between the two oldest keyframes is preserved. The refinement is
    accepted only if the error did not grow (>2%) and every pose and valid
    landmark is finite; otherwise the input window comes back unchanged —
    lane by lane, when the window carries a lane axis.

    `reduce_fn` (see `_gn_step`) also sums the error terms and the finite
    veto, so every rank of a landmark-sharded window takes the same accept
    decision. None is the single-device solver.
    """
    out, errs, _ = ba_refine_verdict(window, K, iters, damping, huber_px, reduce_fn, fix_scale)
    return out, errs


def ba_refine_verdict(
    window: BAWindow,
    K: torch.Tensor,
    iters: int = 5,
    damping: float = 1e-3,
    huber_px: float = 2.0,
    reduce_fn=None,
    fix_scale: bool = True,
) -> tuple[BAWindow, torch.Tensor, torch.Tensor]:
    """`ba_refine`, and its accept veto's verdict: (...) bool, True on the
    lanes whose refinement was kept."""
    if window.kf_pose.ndim == 2:
        # One window is a batch of one lane: the same reduction shapes as a
        # lane of a larger batch, so the two round alike (the 1e8 gauge
        # amplifies any difference in summation order).
        out, errs, accept = ba_refine_verdict(
            BAWindow(*(f[None] for f in window)), K.reshape(1, 3, 3), iters, damping,
            huber_px, reduce_fn, fix_scale)
        return BAWindow(*(f[0] for f in out)), errs[0], accept[0]
    reduce_fn = reduce_fn or _same
    pose_shape = window.kf_pose.shape[:-1] + (4, 4)
    err0 = _mean_reproj_err(window, K, reduce_fn)
    centers0 = window.kf_pose.reshape(pose_shape)[..., :3, 3]
    i0, i1, has2 = _two_oldest_valid(window.kf_valid)
    d_before = torch.linalg.vector_norm(pick(centers0, i1) - pick(centers0, i0), dim=-1)

    refined = window
    errs = []
    for _ in range(iters):
        kf_pose, landmark, err = _gn_step(refined, K, damping, huber_px, reduce_fn)
        refined = refined._replace(kf_pose=kf_pose, landmark=landmark)
        errs.append(err)

    if fix_scale:
        poses = refined.kf_pose.reshape(pose_shape).clone()
        centers = poses[..., :3, 3]
        anchor = pick(centers, i0)
        d_after = torch.linalg.vector_norm(pick(centers, i1) - anchor, dim=-1)
        s = torch.where(has2 & (d_after > 1e-9), d_before / d_after, 1.0)[..., None, None]
        anchor = anchor[..., None, :]
        poses[..., :3, 3] = anchor + s * (centers - anchor)
        refined = refined._replace(
            kf_pose=poses.reshape(window.kf_pose.shape),
            landmark=anchor + s * (refined.landmark - anchor),
        )

    err1 = _mean_reproj_err(refined, K, reduce_fn)
    bad = reduce_fn((~torch.isfinite(refined.kf_pose)).sum(dim=(-2, -1)) + (
        refined.lm_valid[..., None] & ~torch.isfinite(refined.landmark)
    ).sum(dim=(-2, -1)))
    accept = torch.isfinite(err1) & (err1 <= err0 * 1.02) & (bad == 0)
    return where_window(accept, refined, window), torch.stack(errs, dim=-1), accept
